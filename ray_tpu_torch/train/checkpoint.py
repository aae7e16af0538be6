"""Save and restore a train state (counterpart of `save_state` /
`restore_state` in `ray_tpu/train/checkpoint.py`, which use orbax there).

The state (params, optimizer moments and step) is written with
`torch.save` to one file, atomically: tmp in the same directory + fsync +
rename + directory fsync, copied from the JAX package's
`atomic_write_bytes`, so the path holds either the whole checkpoint or
none. The sharded `Checkpoint`/`CheckpointManager` and the manifest
protocol come with the trainer slice of the port.
"""

from __future__ import annotations

import io
import os
import tempfile

import torch

from ray_tpu_torch.train.optim import tree_leaves, tree_map


def _fsync_dir(path: str) -> None:
    # Directory fsync publishes the rename itself; ignore filesystems that
    # refuse to fsync a directory fd (the rename is still atomic there).
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp (same dir) + fsync + rename + dir fsync: `path` either holds
    the complete bytes or does not exist — never a torn prefix."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_" + os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(d)


def save_state(state, path: str) -> None:
    """Write `state` (a `TrainState`) to the file `path`, creating its
    directory."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.BytesIO()
    torch.save({"params": tree_map(lambda t: t.detach(), state.params),
                "opt_state": state.opt_state.state_dict(),
                "step": state.step.detach()}, buf)
    atomic_write_bytes(path, buf.getvalue())


def restore_state(path: str, target):
    """Read a checkpoint into `target`, a TrainState from `init_fn` over
    params of the same tree: params, moments and step are copied into it
    in place, on its devices. Returns `target`."""
    blob = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    with torch.no_grad():
        for dst, src in zip(tree_leaves(target.params),
                            tree_leaves(blob["params"]), strict=True):
            dst.copy_(src)
        target.step.copy_(blob["step"])
    # The moments move to each param's device; the per-leaf step counts
    # stay host scalars, as torch's AdamW keeps them.
    target.opt_state.load_state_dict(blob["opt_state"])
    return target

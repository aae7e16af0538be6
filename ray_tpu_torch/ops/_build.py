"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with nvcc for `sm_90a` into a shared library with a
plain C interface, loaded with ctypes (no PyTorch headers: a build takes
seconds, not minutes). Builds happen at first use into `ray_tpu_torch/
_build/`, keyed by a hash of the source, every shared header
(`csrc/*.cuh`) and the flags, so a checkout builds its own kernels and an
edited source or header rebuilds.
Nothing here runs at import time: the CPU tests import every module on a
host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
SOURCES = ("paged_decode", "paged_verify", "flash_fwd", "flash_bwd")
# The `dtype` argument of every C entry point.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels run a head_dim that is a multiple of 8 (a row is then a
# multiple of 16 bytes, as the bulk copies need, and the JAX package's
# Pallas condition is `hd % 8 == 0`); the wrappers zero-pad any other
# head_dim up to the next one (`padded_head_dim`).
HEAD_DIM_ALIGN = 8

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of ray_tpu_torch are built from source at first use")


def _paths(name: str) -> tuple[Path, Path]:
    h = hashlib.sha256()
    for p in (_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))):
        h.update(p.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    tag = h.hexdigest()[:16]
    return (_BUILD_DIR / f"{name}-{tag}.so", _BUILD_DIR / f"{name}-{tag}.log")


def _start(name: str):
    so, log = _paths(name)
    if so.exists():
        return None
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, so, log


def _finish(name: str, job) -> None:
    proc, tmp, so, log = job
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(rc {proc.returncode}):\n{out}")
    os.replace(tmp, so)


def build_all() -> dict[str, str]:
    """Compile every kernel source that has no current build, one nvcc per
    source, all started together. Returns {name: nvcc/ptxas log}."""
    with _LOCK:
        jobs = {n: _start(n) for n in SOURCES}
        errors = []
        for n, job in jobs.items():
            if job is not None:
                try:
                    _finish(n, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: _paths(n)[1].read_text() if _paths(n)[1].exists() else ""
            for n in SOURCES}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_paths(name)[0]))
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        return lib


def padded_head_dim(hd: int) -> int:
    """The head_dim a kernel runs for `hd`: the next multiple of 8. Zero
    columns add nothing to q . k and give zero output columns, which the
    wrappers cut off (the JAX package runs its XLA path there instead)."""
    return -(-hd // HEAD_DIM_ALIGN) * HEAD_DIM_ALIGN


def pad_cols(d8: int, *ts) -> list:
    """`ts` zero-padded along the last (head) dim to `d8` columns; one
    that is already `d8` wide comes back as it is."""
    return [t if t.shape[-1] == d8
            else torch.nn.functional.pad(t, (0, d8 - t.shape[-1]))
            for t in ts]


def check_head_dim(what: str, hd: int) -> None:
    """Raise ValueError for a head_dim no kernel takes: the kernels take
    every positive one (`padded_head_dim`; widths past 256 run in
    128-column chunks)."""
    if hd < 1:
        raise ValueError(f"{what}: the kernels take any positive head_dim, "
                         f"got {hd}")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if rc != 0:
        msg = lib.rt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")

"""Learner / LearnerGroup: gradient updates on the card, counterpart of the
JAX package's `rllib/core/learner.py`.

The reference builds `optax.chain(clip_by_global_norm(grad_clip),
adam(lr))` and jits loss, gradient and apply into one program. Here an
update is the loss's forward, `torch.autograd.grad`, optax's clipping
rule (`clip_by_global_norm`: scale by max_norm / g_norm only when
g_norm >= max_norm) and Adam as `train/optim.py`'s AdamW at weight decay
0 (optax's `adam`: moments zero at init, eps outside the square root).
The parameters are a tree of leaf tensors that the optimizer updates in
place; metrics stay on the device until the update's one host read.

Multi-learner groups are learner actors on the port's runtime that
average their gradients with a host allreduce (`util/collective`) before
applying them, as the reference's do. A CUDA group's actors reserve
`1 / num_learners` of a card each: a worker without a GPU reservation
sees no device. Weights leave a learner as numpy (`get_weights`), never
as CUDA tensors. The reference's dp mesh for one learner (`mesh=`) and
its `__graphcheck__` hook are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import resolve_device
from ray_tpu_torch.rllib.core.rl_module import (
    fp32_products,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
)
from ray_tpu_torch.train.optim import adamw


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm's rule on a list of gradients, on the
    device (no host read): g * max_norm / g_norm where g_norm >= max_norm,
    else g."""
    g_norm = torch.sqrt(torch.stack([g.square().sum() for g in grads]).sum())
    keep = g_norm < max_norm
    return [torch.where(keep, g, g / g_norm * max_norm) for g in grads]


def as_tensor(v, device) -> torch.Tensor:
    """A batch column on `device`; a read-only numpy array (an object-store
    view) is copied first, as torch takes no read-only memory."""
    if isinstance(v, np.ndarray) and not v.flags.writeable:
        v = v.copy()
    return torch.as_tensor(v, device=device)


def to_device(batch: dict, device) -> dict:
    """A batch on `device`: each column, and each leaf of a nested tree
    (DQN's target params ride the batch as one). A tensor already there
    is passed as it is, so a tree kept on the card is not copied per
    update."""
    return {k: tree_map(lambda v: as_tensor(v, device), v)
            for k, v in batch.items()}


def _rows(v) -> bool:
    """Whether a batch entry is a column of rows (split across learners)
    rather than a tree every learner takes whole."""
    return isinstance(v, (np.ndarray, torch.Tensor))


def read_metrics(metrics: dict) -> dict:
    """A dict of 0-d device tensors -> floats, in one host read."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].detach().float() for k in keys]).tolist()
    return dict(zip(keys, vals))


class Learner:
    """Owns the params and the optimizer. `loss_fn(params, batch,
    **loss_cfg) -> (loss, aux_dict)` comes from the algorithm; the learner
    is algorithm-agnostic. `device` is where the params live: CUDA unless
    the caller asks for the CPU (asking for CUDA without a card raises)."""

    def __init__(self, module, loss_fn, *, lr=3e-4, seed=0,
                 grad_clip: float | None = None,
                 loss_cfg: dict | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.module = module
        self.params = tree_map(lambda t: t.requires_grad_(True),
                               module.init(seed, device=self.device))
        self._leaves = tree_leaves(self.params)
        self.grad_clip = grad_clip
        # AdamW at weight decay 0 over the leaves, in tree order
        self.optimizer = adamw(lr, weight_decay=0.0).init(
            dict(enumerate(self._leaves)))
        self._loss_fn = loss_fn
        self._loss_cfg = dict(loss_cfg or {})

    def grads(self, batch: dict, loss_fn=None):
        """-> (loss, aux, grads): the loss of `batch` (tensors on the
        device) and its gradients, products in full fp32. A leaf the loss
        does not read (BC's value head) gets zeros, as jax.grad gives."""
        fn = loss_fn or self._loss_fn
        with fp32_products():
            loss, aux = fn(self.params, batch, **self._loss_cfg)
            grads = torch.autograd.grad(loss, self._leaves,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(self._leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def apply(self, grads) -> None:
        """Clip (when grad_clip is set) and take one Adam step."""
        if self.grad_clip:
            grads = clip_by_global_norm(list(grads), self.grad_clip)
        for p, g in zip(self._leaves, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, batch: dict, loss_fn=None):
        """One SGD step on a batch already on the device -> (loss, aux),
        both on the device. `loss_fn` (taking the params and the batch)
        stands in for the learner's own, as the on-card iterations pass
        theirs."""
        loss, aux, grads = self.grads(batch, loss_fn)
        self.apply(grads)
        return loss, aux

    @staticmethod
    def _metrics(loss, aux) -> dict:
        return read_metrics({"total_loss": loss, **aux})

    def update(self, batch: dict) -> dict:
        return self._metrics(*self.step(to_device(batch, self.device)))

    def epoch_permutations(self, n: int, num_epochs: int, seed: int):
        """[num_epochs, n] row orders for `update_epochs`, from a CPU
        generator seeded with `seed` (a test may replace this method to feed
        the JAX package's permutations)."""
        gen = torch.Generator().manual_seed(int(seed))
        return torch.stack([torch.randperm(n, generator=gen)
                            for _ in range(num_epochs)])

    def update_epochs(self, batch: dict, *, num_epochs: int,
                      minibatch_size: int, seed: int = 0) -> dict | None:
        """The epochs x shuffled-minibatches sweep with one metrics read at
        its end (the last minibatch's loss and aux, as the reference's fused
        sweep returns). None (the caller falls back to its per-minibatch
        loop) when the batch does not tile into minibatches, as the
        reference's."""
        batch = to_device(batch, self.device)
        n = next(iter(batch.values())).shape[0]
        if n % minibatch_size:
            return None
        nmb = n // minibatch_size
        perms = torch.as_tensor(self.epoch_permutations(n, num_epochs, seed),
                                device=self.device)
        loss = aux = None
        for e in range(num_epochs):
            idxs = perms[e, :nmb * minibatch_size].view(nmb, minibatch_size)
            for j in range(nmb):
                mb = {k: v.index_select(0, idxs[j]) for k, v in batch.items()}
                loss, aux = self.step(mb)
        return self._metrics(loss, aux)

    def get_weights(self):
        return params_to_numpy(self.params)

    def set_weights(self, weights) -> None:
        """Copy a tree of numpy arrays or tensors into the params in place
        (the optimizer keeps its moments, as the reference keeps
        opt_state)."""
        src = tree_leaves(params_from_numpy(tree_map(np.asarray, weights),
                                            self.device))
        if len(src) != len(self._leaves):
            raise ValueError(f"weights have {len(src)} leaves, the module "
                             f"{len(self._leaves)}")
        with torch.no_grad():
            for p, w in zip(self._leaves, src):
                p.copy_(w.reshape(p.shape))


class _CollectiveLearner(Learner):
    """Learner actor of a multi-learner group: averages its gradients over
    the group with one host allreduce before applying them (parity: the
    DDP allreduce between torch learner workers)."""

    def __init__(self, rank: int, world: int, group: str, module, loss_fn,
                 **kw):
        from ray_tpu_torch.util import collective
        self.rank, self.world, self.group = rank, world, group
        collective.init_collective_group(world, rank, group_name=group)
        super().__init__(module, loss_fn, **kw)

    def update(self, batch: dict) -> dict:
        from ray_tpu_torch.util import collective
        loss, aux, grads = self.grads(to_device(batch, self.device))
        # one allreduce of the flat gradient (an elementwise sum in rank
        # order, as the reference's allreduce of each leaf), then the mean
        flat = torch.cat([g.reshape(-1) for g in grads])
        collective.allreduce(flat, group_name=self.group)
        flat /= self.world
        self.apply([f.view_as(g) for f, g in
                    zip(torch.split(flat, [g.numel() for g in grads]),
                        grads)])
        return self._metrics(loss, aux)

    def ping(self):
        return "ok"


def _as_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


class LearnerGroup:
    """num_learners == 0: one learner in this process on `device`.
    num_learners > 0: learner actors on the port's runtime, each on
    `device` (a CUDA group reserves 1 / num_learners of a card each), with
    the collective allreduce (parity: learner_group.py:72)."""

    def __init__(self, module, loss_fn, *, num_learners: int = 0,
                 config: dict | None = None, device="cuda"):
        cfg = dict(config or {})
        if num_learners == 0:
            self.local = Learner(module, loss_fn, device=device, **cfg)
            self.remotes = []
            return
        self.local = None
        gpus = (1.0 / num_learners
                if torch.device(device).type == "cuda" else 0)
        group = f"learners-{id(self)}"
        cls = rt.remote(num_cpus=1, num_gpus=gpus)(_CollectiveLearner)
        self.remotes = [
            cls.remote(i, num_learners, group, module, loss_fn,
                       device=device, **cfg)
            for i in range(num_learners)]
        rt.get([r.ping.remote() for r in self.remotes], timeout=180)

    def update_epochs(self, batch: dict, *, num_epochs: int,
                      minibatch_size: int, seed: int = 0) -> dict | None:
        """The local learner's sweep; None for actor groups (the caller
        falls back to its per-minibatch loop there)."""
        if self.local is not None:
            return self.local.update_epochs(
                batch, num_epochs=num_epochs,
                minibatch_size=minibatch_size, seed=seed)
        return None

    def update(self, batch: dict) -> dict:
        if self.local is not None:
            return self.local.update(batch)
        n = len(self.remotes)
        batch = {k: tree_map(_as_numpy, v) for k, v in batch.items()}
        B = next(v for v in batch.values() if _rows(v)).shape[0]
        if B < n:
            # Every learner must take part in the allreduce; an empty
            # shard would feed NaN gradients into the whole group.
            raise ValueError(
                f"batch of {B} rows cannot be sharded across {n} learners")
        bounds = np.linspace(0, B, n + 1, dtype=int)
        refs = [r.update.remote({k: v[bounds[i]:bounds[i + 1]] if _rows(v)
                                 else v for k, v in batch.items()})
                for i, r in enumerate(self.remotes)]
        results = rt.get(refs, timeout=300)
        return {k: float(np.mean([m[k] for m in results]))
                for k in results[0]}

    def get_weights(self):
        if self.local is not None:
            return self.local.get_weights()
        return rt.get(self.remotes[0].get_weights.remote(), timeout=120)

    def set_weights(self, weights) -> None:
        if self.local is not None:
            self.local.set_weights(weights)
        else:
            rt.get([r.set_weights.remote(weights) for r in self.remotes],
                   timeout=120)

    def stop(self):
        for r in self.remotes:
            try:
                rt.kill(r)
            except Exception:  # noqa: BLE001 - best effort at teardown
                pass

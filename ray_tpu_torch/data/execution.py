"""Streaming executor: runs a logical plan as windowed task pipelines
(counterpart of `ray_tpu/data/execution.py`).

Parity: reference `data/_internal/execution/streaming_executor.py:48` —
blocks stream through operator stages with bounded in-flight work per stage
(backpressure), map stages run as tasks (TaskPoolMapOperator) or actor pools
(ActorPoolMapOperator, for class UDFs), and all-to-all ops (repartition /
random_shuffle / sort / groupby) run the split+reduce exchange of
`data/_internal/planner/exchange/`.

Design deviation (single driver): instead of the reference's dedicated
scheduling thread + operator-selection loop
(`streaming_executor_state.py:542`), stages are generator pipelines pulled
by the consumer; each stage keeps at most `max_tasks_in_flight` tasks
outstanding, which bounds memory the same way while removing a thread.

A map stage's tasks or actors take the stage's resources (`map_batches(...,
num_cpus=, num_gpus=)`, as in Ray): a worker sees a card only when it
reserved a share of one, so a stage that runs on the card must say so.
The seeded exchanges (shuffle, the sort's sample) draw the JAX package's
numpy streams, so their row order is the JAX package's.
"""

from __future__ import annotations

import collections
import threading
from typing import Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import plan as plan_mod
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks
from ray_tpu_torch.data.context import DataContext

# ---------------- remote task bodies ----------------
# Module-level functions wrapped by ray_tpu_torch.remote below: the
# workers import them by name.


def _read(read_fn):
    block = read_fn()
    return block, BlockAccessor.of(block).metadata()


def _map(fn, block):
    out = fn(block)
    return out, BlockAccessor.of(out).metadata()


def _slice(block, start, end):
    out = BlockAccessor(block).slice(start, end)
    return out, BlockAccessor(out).metadata()


def _sample(block, key, n):
    return BlockAccessor(block).sample(n, key)


def _stable_order(col, descending: bool) -> np.ndarray:
    """Indices sorting `col` stably (ties keep their order), as pyarrow's
    sort_by does in the JAX package, ascending or descending."""
    if not descending:
        return np.argsort(col, kind="stable")
    n = len(col)
    return n - 1 - np.argsort(col[::-1], kind="stable")[::-1]


def _split(fn, block, n, kind, key, boundaries, seed, descending,
           block_index=0, block_start=0):
    """Split one block into n partition pieces (the 'map' half of the
    exchange). kind: repartition | shuffle | sort-range."""
    if fn is not None:
        block = fn(block)
    acc = BlockAccessor.of(block)
    rows = acc.num_rows()
    if kind == "repartition":
        # Order-preserving: output j owns global rows
        # [boundaries[j], boundaries[j+1]); this block covers
        # [block_start, block_start + rows).
        pieces = []
        for j in range(n):
            lo = max(boundaries[j] - block_start, 0)
            hi = max(min(boundaries[j + 1] - block_start, rows), lo)
            pieces.append(acc.slice(lo, hi))
    elif kind == "shuffle":
        # Distinct stream per block (seed, block_index) — one shared stream
        # would give every equally-sized block identical assignments.
        rng = np.random.default_rng((seed, 0, block_index))
        assign = rng.integers(0, n, rows)
        pieces = [acc.take_indices(np.nonzero(assign == i)[0])
                  for i in range(n)]
    else:  # sort-range partition by key against boundaries
        col = acc.block[key] if rows else np.zeros(0)
        part = np.searchsorted(np.asarray(boundaries), col,
                               side="right")
        if descending:
            part = (n - 1) - part
        pieces = [acc.take_indices(np.nonzero(part == i)[0])
                  for i in range(n)]
    return tuple(pieces) if n > 1 else pieces[0]


def _reduce(kind, key, descending, aggregate, seed, part_index, *pieces):
    block = concat_blocks(list(pieces))
    acc = BlockAccessor(block)
    if kind == "shuffle" and acc.num_rows():
        # Rows landed in input order; permute within the output partition.
        rng = np.random.default_rng((seed, 1, part_index))
        block = acc.take_indices(rng.permutation(acc.num_rows()))
    if kind in ("sort", "groupby") and acc.num_rows() and key is not None:
        block = acc.take_indices(_stable_order(block[key], descending))
    if kind == "groupby" and aggregate is not None:
        block = aggregate(block)
    return block, BlockAccessor(block).metadata()


def _zip_pair(left_block, slices, *right_blocks):
    """Zip one left block against the right-side row range it lines up
    with; `slices` = [(right_block_pos, start, end), ...]."""
    left = dict(left_block)
    right = concat_blocks([
        BlockAccessor(right_blocks[pos]).slice(s, e)
        for pos, s, e in slices])
    n_left, n_right = (BlockAccessor(left).num_rows(),
                       BlockAccessor(right).num_rows())
    if n_left != n_right:
        raise ValueError(f"zip alignment bug: {n_left} vs {n_right}")
    for name, col in right.items():
        left[name if name not in left else name + "_1"] = col
    return left, BlockAccessor(left).metadata()


_read_task = ray_tpu_torch.remote(num_returns=2)(_read)
_map_task = ray_tpu_torch.remote(num_returns=2)(_map)
_slice_task = ray_tpu_torch.remote(num_returns=2)(_slice)
_sample_task = ray_tpu_torch.remote(_sample)
_split_task = ray_tpu_torch.remote(_split)
_reduce_task = ray_tpu_torch.remote(num_returns=2)(_reduce)
_zip_pair_task = ray_tpu_torch.remote(num_returns=2)(_zip_pair)


# ---------------- actor-pool map (class UDFs) ----------------


class _MapWorker:
    """Parity: ActorPoolMapOperator worker — constructs the class UDF once,
    applies it per block."""

    def __init__(self, ctor):
        self._fn = ctor()

    def apply(self, chain_fn, block):
        out = chain_fn(self._fn, block)
        return out, BlockAccessor.of(out).metadata()


# ---------------- the executor ----------------


class _MemoryBudget:
    """Pipeline-global byte accounting for in-flight operator outputs
    (parity: the reference's per-op ResourceManager + backpressure policies,
    concept of streaming_executor_state.py:542). try_acquire never blocks —
    the window loop falls back to draining its own completions, and the
    liveness rule (one task per starved stage) rides the `force` path so a
    budget smaller than one block can never deadlock the pipeline."""

    def __init__(self, limit: int):
        self.limit = limit
        self.used = 0
        self.peak = 0
        self._lock = threading.Lock()

    def try_acquire(self, nbytes: int, force: bool = False) -> bool:
        if not self.limit:
            return True
        with self._lock:
            if not force and self.used + nbytes > self.limit:
                return False
            self.used += nbytes
            self.peak = max(self.peak, self.used)
            return True

    def release(self, nbytes: int):
        if not self.limit:
            return
        with self._lock:
            self.used = max(0, self.used - nbytes)


def execute(logical_plan: plan_mod.LogicalPlan,
            ctx: DataContext | None = None) -> Iterator[tuple]:
    """Yields (block_ref, BlockMetadata) in order."""
    ctx = ctx or DataContext.get_current()
    plan = logical_plan.optimized()
    budget = _MemoryBudget(ctx.memory_budget_bytes)
    ctx._budget = budget  # observable by tests/metrics
    stream: Iterator[tuple] | None = None
    for op in plan.ops:
        stream = _apply_op(op, stream, ctx, budget)
    return stream if stream is not None else iter(())


def _apply_op(op, upstream, ctx: DataContext, budget=None):
    budget = budget or _MemoryBudget(0)
    if isinstance(op, plan_mod.Read):
        return _read_stage(op, ctx, budget)
    if isinstance(op, plan_mod.InputData):
        return iter(op.refs)
    if isinstance(op, plan_mod.MapBlocks):
        if op.fn_constructor is not None:
            return _actor_map_stage(op, upstream, ctx)
        return _task_map_stage(op, upstream, ctx, budget)
    if isinstance(op, plan_mod.AllToAll):
        return _all_to_all_stage(op, upstream, ctx)
    if isinstance(op, plan_mod.Limit):
        return _limit_stage(op, upstream)
    if isinstance(op, plan_mod.Union):
        return _union_stage(op, upstream, ctx)
    if isinstance(op, plan_mod.Zip):
        return _zip_stage(op, upstream, ctx)
    raise TypeError(f"unknown logical op {op}")


def _finish(pair):
    bref, mref = pair
    return bref, ray_tpu_torch.get(mref, timeout=600)


# ---------------- locality hints ----------------


def _owner_node(bref) -> str | None:
    """Hex id of the node holding bref's block, or None (client-mode
    driver, worker-nested execution, inline entry, dead owner)."""
    from ray_tpu_torch.core.runtime import Runtime, current_runtime
    rt = current_runtime()
    if not isinstance(rt, Runtime):
        return None  # only the head driver sees the object directory
    try:
        return rt.node_of_object(bref.id.binary())
    except Exception:  # noqa: BLE001 — directory churn: hint is optional
        return None


def _locality_strategy(ctx, cache: dict, bref):
    """Soft NodeAffinity for the node owning `bref`, or None. Cached per
    node PER STAGE: the head's scheduling queues key non-string
    strategies by identity, so reusing one object per node keeps a
    stage's same-node submissions on one queue."""
    if not ctx.locality_hints:
        return None
    nid = _owner_node(bref)
    if nid is None:
        return None
    strat = cache.get(nid)
    if strat is None:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        strat = cache[nid] = NodeAffinitySchedulingStrategy(nid, soft=True)
    return strat


def _windowed(submits, window: int, budget=None, est_bytes=None):
    """Submit lazily, keep <= window tasks in flight, yield in order.

    With a budget, a submit additionally needs `est` bytes of the global
    budget; a starved stage first drains its own completions, and a stage
    with nothing in flight submits anyway (liveness — the pipeline always
    makes progress even when one block exceeds the whole budget)."""
    pending = collections.deque()  # (task_refs, acquired_bytes)

    def finish_one():
        refs, nbytes = pending.popleft()
        out = _finish(refs)
        if budget is not None:
            budget.release(nbytes)
        return out

    for item in submits:
        submit, est = (item if isinstance(item, tuple) else (item, 0))
        if est_bytes is not None:
            est = est_bytes
        while len(pending) >= window:
            yield finish_one()
        if budget is not None:
            while (pending and not budget.try_acquire(est)):
                yield finish_one()
            if not pending:
                budget.try_acquire(est, force=True)  # liveness
        pending.append((submit(), est))
    while pending:
        yield finish_one()


def _read_stage(op: plan_mod.Read, ctx, budget=None):
    return _windowed(
        ((lambda fn=fn: _read_task.remote(fn)) for fn in op.read_fns),
        ctx.max_tasks_in_flight, budget=budget,
        est_bytes=ctx.target_min_block_size)


def _task_map_stage(op: plan_mod.MapBlocks, upstream, ctx, budget=None):
    # Estimate each output at its input block's size (metadata is exact for
    # the upstream block; maps are usually size-preserving or shrinking).
    # Each submit carries a soft locality hint for the block's owner node,
    # so a map chain follows its blocks instead of pulling them.
    affinity: dict = {}
    return _windowed(
        (((lambda bref=bref, s=_locality_strategy(ctx, affinity, bref):
           _map_task.options(scheduling_strategy=s, **op.ray_remote_args)
           .remote(op.fn, bref)),
          int(meta.size_bytes or ctx.target_min_block_size))
         for bref, meta in upstream),
        ctx.max_tasks_in_flight, budget=budget)


def _actor_map_stage(op: plan_mod.MapBlocks, upstream, ctx):
    size = op.compute if isinstance(op.compute, int) else 2

    def gen():
        # The pool lives for this execution only: every actor (and the
        # resources it holds: a card's share, its memory) goes in the
        # finally, also when the consumer stops early (take, limit).
        workers = []
        try:
            cls = ray_tpu_torch.remote(_MapWorker).options(
                **op.ray_remote_args)
            workers = [cls.remote(op.fn_constructor) for _ in range(size)]
            pending = collections.deque()
            rr = 0
            for bref, _meta in upstream:
                while len(pending) >= max(size, 1):
                    yield _finish(pending.popleft())
                w = workers[rr % size]
                rr += 1
                pending.append(w.apply.options(num_returns=2)
                               .remote(op.fn, bref))
            while pending:
                yield _finish(pending.popleft())
        finally:
            for w in workers:
                ray_tpu_torch.kill(w)

    return gen()


def _all_to_all_stage(op: plan_mod.AllToAll, upstream, ctx):
    kind = op.kind
    args = op.args
    inputs = list(upstream)  # materialization barrier (exchange needs all)
    if not inputs:
        return iter(())
    n_out = args.get("num_blocks") or len(inputs)
    key = args.get("key")
    descending = bool(args.get("descending"))
    aggregate = args.get("aggregate")
    pre_fn = args.get("pre_fn")
    boundaries = None
    block_starts = [0] * len(inputs)
    split_kind = {"repartition": "repartition", "shuffle": "shuffle",
                  "sort": "sort", "groupby": "sort"}[kind]
    if split_kind == "repartition":
        total = sum(m.num_rows for _b, m in inputs)
        boundaries = [total * j // n_out for j in range(n_out + 1)]
        off = 0
        for i, (_b, m) in enumerate(inputs):
            block_starts[i] = off
            off += m.num_rows
    if split_kind == "sort":
        samples = ray_tpu_torch.get(
            [_sample_task.remote(bref, key, 16) for bref, _ in inputs],
            timeout=600)
        flat = sorted(s for block in samples for s in block)
        if not flat:
            boundaries = []
            n_out = 1
        else:
            idx = [len(flat) * i // n_out for i in range(1, n_out)]
            boundaries = [flat[i] for i in idx]

    affinity: dict = {}

    def submit_split(bref, idx):
        # The exchange's map half reads one block: keep it block-local.
        return _split_task.options(
            num_returns=n_out,
            scheduling_strategy=_locality_strategy(ctx, affinity, bref),
        ).remote(pre_fn, bref, n_out, split_kind, key, boundaries,
                 args.get("seed"), descending, idx, block_starts[idx])

    piece_refs = []  # [n_inputs][n_out]
    for idx, (bref, _meta) in enumerate(inputs):
        out = submit_split(bref, idx)
        piece_refs.append([out] if n_out == 1 else list(out))

    reduce_kind = "sort" if kind == "sort" else kind

    def submits():
        for j in range(n_out):
            cols = [piece_refs[i][j] for i in range(len(inputs))]
            yield (lambda c=cols, j=j: _reduce_task.remote(
                reduce_kind, key, descending, aggregate,
                args.get("seed"), j, *c))

    return _windowed(submits(), ctx.max_tasks_in_flight)


def split_refs_at(refs: list, cuts: list[int]) -> list[list]:
    """Partition materialized (ref, meta) pairs at global row indices,
    slicing blocks that straddle a boundary."""
    shards = []
    cur: list = []
    cuts = list(cuts)
    pos = 0
    for bref, meta in refs:
        start, end = pos, pos + meta.num_rows
        pos = end
        while cuts and start <= cuts[0] <= end:
            cut = cuts.pop(0)
            if cut > start:
                cur.append(_finish(_slice_task.remote(bref, 0, cut - start)))
            shards.append(cur)
            cur = []
            if cut < end:
                bref, meta = _finish(_slice_task.remote(
                    bref, cut - start, end - start))
                start = cut
            else:
                bref = None
                break
        if bref is not None and meta.num_rows > 0:
            cur.append((bref, meta))
    shards.append(cur)
    return shards


def _limit_stage(op: plan_mod.Limit, upstream):
    def gen():
        remaining = op.n
        for bref, meta in upstream:
            if remaining <= 0:
                break
            if meta.num_rows <= remaining:
                remaining -= meta.num_rows
                yield bref, meta
            else:
                yield _finish(_slice_task.remote(bref, 0, remaining))
                remaining = 0
                break
    return gen()


def _union_stage(op: plan_mod.Union, upstream, ctx):
    def gen():
        yield from upstream
        for other in op.others:
            yield from execute(other, ctx)
    return gen()


def _zip_stage(op: plan_mod.Zip, upstream, ctx):
    """Block-pairwise zip: each left block zips against the right-side row
    range it aligns with — stays distributed, preserves left's block layout
    (parity: data ZipOperator aligning bundles by row)."""
    def gen():
        left = list(upstream)
        right = list(execute(op.other, ctx))
        n_left = sum(m.num_rows for _b, m in left)
        n_right = sum(m.num_rows for _b, m in right)
        if n_left != n_right:
            raise ValueError(
                f"zip requires equal row counts, got {n_left} vs {n_right}")
        # Global row offsets of each right block.
        r_starts = []
        off = 0
        for _b, m in right:
            r_starts.append(off)
            off += m.num_rows

        def right_range(a, b):
            out = []
            for j, (rb, rm) in enumerate(right):
                s, e = r_starts[j], r_starts[j] + rm.num_rows
                lo, hi = max(a, s), min(b, e)
                if lo < hi:
                    out.append((j, lo - s, hi - s))
            return out

        def submits():
            a = 0
            for lb, lm in left:
                b = a + lm.num_rows
                slices = right_range(a, b)
                rrefs = [right[j][0] for j, _s, _e in slices]
                local = [(k, s, e)
                         for k, (_j, s, e) in enumerate(slices)]
                a = b
                yield (lambda lb=lb, local=local, rrefs=rrefs:
                       _zip_pair_task.remote(lb, local, *rrefs))

        yield from _windowed(submits(), ctx.max_tasks_in_flight)
    return gen()

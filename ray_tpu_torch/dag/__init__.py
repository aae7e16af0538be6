"""Compiled graphs: static actor DAGs over mutable shm channels
(counterpart of `ray_tpu/dag/__init__.py`).

Parity: reference `python/ray/dag/` — build a DAG of actor method calls
(`dag_node.py`, `class_node.py`), `experimental_compile`
(`dag_node.py:265`) -> `CompiledDAG` (`compiled_dag_node.py:805`) whose
per-actor exec loops run once and stream values over mutable channels
(`do_exec_tasks`, `compiled_dag_node.py:193`); execute() writes the input
channel and returns a ref resolved from the output channel — no per-call
task submission RPCs.

Usage note (same as the reference's): the win is pipeline-parallel
inference: each stage actor holds its part of a model on its card, and
tensor channels carry the activations between stages (a CUDA tensor as
one device-to-host copy into the channel and one host-to-device copy onto
the next stage's card).

`_exec_loop` is a module-level function: it ships by reference through
the worker's `__run_with_instance__` hook, on a host without cloudpickle
too.
"""

from __future__ import annotations

import threading

from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelClosedError,
    TensorChannel,
)

__all__ = ["InputNode", "MultiOutputNode", "CompiledDAG",
           "ChannelClosedError"]


def _chan_cls(channel_type: str):
    if channel_type == "tensor":
        return TensorChannel
    if channel_type == "pickle":
        return Channel
    raise ValueError(f"unknown channel_type {channel_type!r} "
                     "(expected 'tensor' or 'pickle')")


def _default_channel_type() -> str:
    try:
        from ray_tpu_torch.core.config import get_config
        return get_config().dag_channel_type
    except Exception:  # noqa: BLE001 — config not importable (bare tests)
        return "tensor"


class DAGNode:
    def experimental_compile(self, buffer_size_bytes: int = 1 << 20,
                             channel_type: str | None = None
                             ) -> "CompiledDAG":
        """channel_type: 'tensor' (default; array leaves cross each hop
        as one memcpy, no pickle) or 'pickle' (the legacy whole-value
        pickle frames)."""
        return CompiledDAG(self, buffer_size_bytes,
                           channel_type or _default_channel_type())

    def _deps(self):
        return [a for a in getattr(self, "args", ())
                if isinstance(a, DAGNode)]


class InputNode(DAGNode):
    """`with InputNode() as inp:` — the DAG's parameter (parity:
    dag/input_node.py)."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class ClassMethodNode(DAGNode):
    def __init__(self, handle, method_name: str, args, kwargs):
        self.handle = handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        if kwargs:
            raise ValueError("compiled graphs take positional args only")


class MultiOutputNode(DAGNode):
    def __init__(self, outputs):
        self.args = list(outputs)


def _exec_loop(instance, schedule, in_specs, out_path,
               channel_type: str = "pickle"):
    """Runs INSIDE the actor (via __run_with_instance__): read inputs,
    apply methods, write outputs, forever — until the input channels close.
    schedule: [(method_name, [arg_src...], out_idx)] in topo order; arg_src
    is ("chan", i) or ("const", value) or ("local", j) for a value produced
    earlier in this actor's own schedule. in_specs: [(path, reader_idx)].

    Tensor channels hand numpy leaves to the stage as READ-ONLY views
    aliasing the input channel; the ack (which lets the upstream writer
    overwrite) is released only AFTER the stage's output is written:
    writing stages the output, so the input bytes are consumed by then.
    Stage methods must not retain input views across calls. torch leaves
    arrive as fresh tensors, CUDA ones on this actor's card (a stage that
    sees no card raises on the first CUDA leaf)."""
    cls = _chan_cls(channel_type)
    ins = [cls(p, reader_idx=ri) for p, ri in in_specs]
    out = cls(out_path)
    tensor = channel_type == "tensor"
    try:
        while True:
            try:
                chan_vals = [ch.read(timeout=None) for ch in ins]
            except ChannelClosedError:
                out.close_writer()  # propagate EOF down the pipeline
                return "closed"
            local_vals = {}
            for method_name, arg_srcs, out_idx in schedule:
                args = []
                for kind, i in arg_srcs:
                    if kind == "chan":
                        args.append(chan_vals[i])
                    elif kind == "local":
                        args.append(local_vals[i])
                    else:
                        args.append(i)
                local_vals[out_idx] = getattr(instance, method_name)(*args)
            out.write(local_vals[schedule[-1][2]])
            if tensor:
                del chan_vals, args, local_vals  # drop borrowed views
                for ch in ins:
                    ch.release()
    finally:
        for ch in ins:
            ch.close()
        out.close()


class CompiledDAGRef:
    """Future over the compiled DAG's output channel (parity:
    CompiledDAGRef). Results must be consumed in execution order."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: float | None = 60.0):
        return self._dag._result(self._seq, timeout)


class CompiledDAG:
    def __init__(self, output_node: DAGNode, buffer_size_bytes: int,
                 channel_type: str = "tensor"):
        self._buffer = buffer_size_bytes
        self._channel_type = channel_type
        self._cls = _chan_cls(channel_type)
        self._lock = threading.Lock()
        self._seq = 0
        self._read_seq = 0
        self._results: dict[int, object] = {}
        self._build(output_node)

    # ---- compilation ----

    def _build(self, output_node: DAGNode):
        # Topo order over the node graph.
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(n: DAGNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            for d in n._deps():
                visit(d)
            order.append(n)

        visit(output_node)
        inputs = [n for n in order if isinstance(n, InputNode)]
        if len(inputs) != 1:
            raise ValueError("a compiled DAG needs exactly one InputNode")
        if isinstance(output_node, MultiOutputNode):
            raise NotImplementedError(
                "MultiOutputNode compilation lands with multi-channel "
                "output support")

        # Per actor: schedule of its ops; channels between actors.
        node_actor = {}
        for n in order:
            if isinstance(n, ClassMethodNode):
                node_actor[id(n)] = n.handle._actor_id
        # A node needs an output channel iff a DIFFERENT actor (or the
        # driver, for the final node) consumes it. n_readers must equal the
        # number of reader CURSORS actually opened — one per consuming
        # ACTOR (an actor consuming a value in several ops still opens one
        # cursor), plus the driver on the output channel — or the writer's
        # per-reader ack backpressure waits on slots nobody writes.
        consumers: dict[int, set] = {id(output_node): {b"__driver__"}}
        input_actors: set = set()
        for n in order:
            if not isinstance(n, ClassMethodNode):
                continue
            aid = node_actor[id(n)]
            for d in n._deps():
                if isinstance(d, InputNode):
                    input_actors.add(aid)
                elif node_actor.get(id(d)) != aid:
                    consumers.setdefault(id(d), set()).add(aid)
        self._input_chan = self._cls(create=True, capacity=self._buffer,
                                     n_readers=max(1, len(input_actors)))
        chans: dict[int, Channel] = {
            nid: self._cls(create=True, capacity=self._buffer,
                           n_readers=len(aids))
            for nid, aids in consumers.items()}
        next_reader: dict[str, int] = {}  # channel path -> next reader idx
        # Reserve the driver's cursor (reader_idx 0) on the output channel.
        next_reader[chans[id(output_node)].path] = 1

        # Group consecutive ops per actor (topo order preserves deps).
        actor_plans: dict[bytes, dict] = {}
        local_idx: dict[int, tuple] = {}  # node id -> (actor_id, slot)

        def chan_arg(plan, path):
            paths = [p for p, _ in plan["in_specs"]]
            if path not in paths:
                ri = next_reader.get(path, 0)
                next_reader[path] = ri + 1
                plan["in_specs"].append((path, ri))
                paths.append(path)
            return "chan", paths.index(path)

        for n in order:
            if not isinstance(n, ClassMethodNode):
                continue
            aid = node_actor[id(n)]
            plan = actor_plans.setdefault(
                aid, {"handle": n.handle, "in_specs": [], "schedule": [],
                      "slots": 0})
            arg_srcs = []
            for a in n.args:
                if isinstance(a, InputNode):
                    arg_srcs.append(chan_arg(plan, self._input_chan.path))
                elif isinstance(a, DAGNode):
                    owner, slot = local_idx[id(a)]
                    if owner == aid:
                        arg_srcs.append(("local", slot))
                    else:
                        arg_srcs.append(chan_arg(plan, chans[id(a)].path))
                else:
                    arg_srcs.append(("const", a))
            slot = plan["slots"]
            plan["slots"] += 1
            plan["schedule"].append((n.method_name, arg_srcs, slot))
            local_idx[id(n)] = (aid, slot)

        # Each actor writes ONE channel (its last op) in this v1 — enforce
        # the common pipeline shape (a chain across actors).
        for nid in chans:
            owner_aid = node_actor.get(nid)
            if owner_aid is None:
                continue
            plan = actor_plans[owner_aid]
            last_slot = plan["schedule"][-1][2]
            if local_idx[nid][1] != last_slot:
                raise NotImplementedError(
                    "only pipeline-shaped DAGs are compiled in v1: each "
                    "actor's final op must be its cross-actor output")
            plan["out_path"] = chans[nid].path

        self._out_chan = chans[id(output_node)]
        self._loops = []
        from ray_tpu_torch.core.actor import ActorMethod
        for aid, plan in actor_plans.items():
            m = ActorMethod(plan["handle"], "__run_with_instance__")
            ref = m._remote((_exec_loop, plan["schedule"],
                             plan["in_specs"], plan["out_path"],
                             self._channel_type), {})
            self._loops.append(ref)
        self._chans = list(chans.values())
        # The driver drains the output channel eagerly so backpressure
        # never waits on a user calling .get().
        self._cv = threading.Condition()
        self._drain = threading.Thread(target=self._drain_loop, daemon=True,
                                       name="dag-drain")
        self._drain.start()

    # ---- execution ----

    def execute(self, value) -> CompiledDAGRef:
        with self._lock:
            self._input_chan.write(value)
            self._seq += 1
            return CompiledDAGRef(self, self._seq)

    def _drain_loop(self):
        tensor = self._channel_type == "tensor"
        while True:
            try:
                # copy=True: the user may hold the result indefinitely, so
                # numpy leaves must not borrow the channel region.
                val = (self._out_chan.read(timeout=None, copy=True)
                       if tensor else self._out_chan.read(timeout=None))
            except (ChannelClosedError, OSError, ValueError):
                return
            with self._cv:
                self._read_seq += 1
                self._results[self._read_seq] = val
                self._cv.notify_all()

    def _result(self, seq: int, timeout):
        with self._cv:
            if not self._cv.wait_for(lambda: seq in self._results,
                                     timeout=timeout):
                raise TimeoutError(f"compiled DAG result {seq} timed out")
            return self._results.pop(seq)

    def teardown(self):
        self._input_chan.close_writer()
        import ray_tpu_torch
        for ref in self._loops:
            try:
                ray_tpu_torch.get(ref, timeout=10)
            except Exception:  # noqa: BLE001 — loop may already be gone
                pass
        seen = set()
        for ch in [self._input_chan, self._out_chan, *self._chans]:
            if ch.path in seen:
                continue
            seen.add(ch.path)
            ch.close()
            ch.unlink()

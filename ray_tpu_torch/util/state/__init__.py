"""State API: cluster introspection (list/summarize live entities).

Parity: reference `python/ray/util/state/` (`ray list
tasks/actors/objects/nodes/workers`, `ray summary tasks` — backed by
`state_manager.py:107` fanning out to GCS + agents). Here the head runtime
IS the control plane, so listing reads its tables directly; remote callers
(workers, `ray_tpu_torch.init(address=...)` clients, the CLI) go through the
head's request channel ("state" op).
"""

from __future__ import annotations

import time


def _query(kind: str, arg=None):
    from ray_tpu_torch.core.runtime import Runtime, get_runtime
    rt = get_runtime()
    if isinstance(rt, Runtime):
        return _dispatch(rt, kind, arg)
    return rt.request("state", (kind, arg))


def _dispatch(rt, kind: str, arg=None):
    """Head-side execution of a state query (also invoked by the head's
    request handler for remote callers)."""
    fn = _HANDLERS[kind]
    return fn(rt) if arg is None else fn(rt, arg)


def list_nodes() -> list[dict]:
    return _query("nodes")


def list_workers() -> list[dict]:
    return _query("workers")


def list_actors() -> list[dict]:
    return _query("actors")


def list_tasks(limit: int = 1000) -> list[dict]:
    """Recent task state transitions, newest last (backed by the head's
    task-event ring, parity: gcs_task_manager.h:94 bounded storage)."""
    return _query("tasks", limit)


def list_objects(limit: int = 1000) -> list[dict]:
    return _query("objects", limit)


def list_placement_groups() -> list[dict]:
    return _query("placement_groups")


def summarize_tasks() -> dict:
    return _query("summarize_tasks")


def summary_tasks() -> dict:
    """Per-function rollup from the task-event pipeline (parity: `ray
    summary tasks`): attempt counts, state breakdown, mean queue/exec/
    total latencies, plus pipeline drop accounting. Works from remote
    callers (workers, clients) through the head's state channel."""
    return _query("summary_tasks")


def list_task_events(limit: int = 1000) -> list[dict]:
    """Merged per-attempt task events from the head's TaskEventStorage
    (parity: `ray list tasks --detail` backed by gcs_task_manager.h:94):
    each row carries the attempt's state-transition history with source
    node/worker, lease_seq and spill hops."""
    return _query("task_events", limit)


def summarize_actors() -> dict:
    return _query("summarize_actors")


def cluster_status() -> dict:
    """One-call overview (what `ray status` prints)."""
    return _query("status")


# ---- head-side implementations ----


def _nodes(rt) -> list[dict]:
    return rt.nodes_table()


def _workers(rt) -> list[dict]:
    out = []
    for wid, w in list(rt.workers.items()):
        out.append({
            "worker_id": wid.hex(),
            "node_id": w.node_id.hex() if w.node_id else "",
            "state": w.state,
            "is_actor": w.actor_id is not None,
            "pid": getattr(w.proc, "pid", None),
        })
    return out


def _actors(rt) -> list[dict]:
    registered = {aid: name for name, aid in rt.named_actors.items()}
    out = []
    for aid, st in list(rt.actors.items()):
        out.append({
            "actor_id": aid.hex(),
            "class_name": st.cspec.name,
            "state": st.state.upper(),
            "name": registered.get(aid, ""),
            "node_id": st.node_id.hex() if st.node_id else "",
            "restarts": st.cspec.restarts_used,
            "pending_calls": len(st.queued) + len(st.inflight),
        })
    return out


def _tasks(rt, limit: int = 1000) -> list[dict]:
    latest: dict[bytes, dict] = {}
    for ts, task_id, name, state in rt.task_events.snapshot():
        latest[task_id] = {"task_id": task_id.hex(), "name": name,
                           "state": state, "ts": ts}
    rows = sorted(latest.values(), key=lambda r: r["ts"])
    return rows[-limit:]


def _objects(rt, limit: int = 1000) -> list[dict]:
    out = []
    with rt.directory.lock:
        items = list(rt.directory.entries.items())[:limit]
    for oid, entry in items:
        kind = entry[0]
        locs = []
        if kind == "shm" and len(entry) > 1:
            locs = [nid.hex() for nid in entry[1]]
        out.append({"object_id": oid.hex(), "kind": kind,
                    "locations": locs})
    return out


def _placement_groups(rt) -> list[dict]:
    table = rt.placement_group_table()
    return [{"placement_group_id": pg_id, **row}
            for pg_id, row in table.items()]


def _summarize_tasks(rt) -> dict:
    by_state: dict[str, int] = {}
    for row in _tasks(rt, limit=100000):
        by_state[row["state"]] = by_state.get(row["state"], 0) + 1
    return {"by_state": by_state, "by_name": rt.task_events.summary()}


def _summary_tasks(rt) -> dict:
    rt.sync_task_store()
    return rt.task_store.summary()


def _task_events(rt, limit: int = 1000) -> list[dict]:
    rt.sync_task_store()
    return rt.task_store.list_events(limit)


def _summarize_actors(rt) -> dict:
    by_state: dict[str, int] = {}
    for row in _actors(rt):
        by_state[row["state"]] = by_state.get(row["state"], 0) + 1
    return {"by_state": by_state}


def _status(rt) -> dict:
    return {
        "timestamp": time.time(),
        "nodes": {"alive": sum(1 for n in rt.nodes_table() if n["alive"]),
                  "dead": sum(1 for n in rt.nodes_table()
                              if not n["alive"])},
        "resources": {"total": rt.cluster_resources(),
                      "available": rt.available_resources()},
        "pending_tasks": len(rt.task_queue),
        "actors": _summarize_actors(rt)["by_state"],
        "store": rt.store.stats(),
        "num_workers": len(rt.workers),
        "tasks_finished_total": rt.task_events.finished_total,
    }


_HANDLERS = {
    "nodes": _nodes,
    "workers": _workers,
    "actors": _actors,
    "tasks": _tasks,
    "objects": _objects,
    "placement_groups": _placement_groups,
    "summarize_tasks": _summarize_tasks,
    "summary_tasks": _summary_tasks,
    "task_events": _task_events,
    "summarize_actors": _summarize_actors,
    "status": _status,
}

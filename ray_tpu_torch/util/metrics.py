"""Application metrics: Counter/Gauge/Histogram + Prometheus exposition.

Parity: reference `python/ray/util/metrics.py` (user-defined metrics via
the Cython metric bridge) and the per-node metrics agent's Prometheus
endpoint (`_private/metrics_agent.py:492`, `prometheus_exporter.py`).
Metrics registered in the driver process render straight into the
Prometheus text format by the dashboard's /metrics route; metrics
registered in WORKER processes ship dirty-registry deltas on the
task-event flush frames (core/worker.py) and merge here at scrape time,
tagged `WorkerId` — the role the reference's per-node metrics agent
plays for core-worker metrics.

Label values are escaped per the Prometheus exposition format
(backslash, double-quote and newline), so a tag value like `he said "hi"`
cannot corrupt the scrape.
"""

from __future__ import annotations

import threading

_REGISTRY: dict[str, "Metric"] = {}
_LOCK = threading.Lock()


def _escape_label_value(v: str) -> str:
    """Exposition-format label escaping: backslash first, then quote and
    newline (https://prometheus.io/docs/instrumenting/exposition_formats)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_label_pairs(keys, values) -> str:
    return ",".join(f'{k}="{_escape_label_value(v)}"'
                    for k, v in zip(keys, values))


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: tuple = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()
        self._dirty = False  # set on writes, cleared by registry_delta()
        with _LOCK:
            _REGISTRY[name] = self

    def _key(self, tags: dict | None) -> tuple:
        tags = tags or {}
        return tuple(str(tags.get(k, "")) for k in self.tag_keys)

    def _fmt_labels(self, key: tuple) -> str:
        if not self.tag_keys:
            return ""
        return "{" + _fmt_label_pairs(self.tag_keys, key) + "}"

    def header(self) -> list[str]:
        return [f"# HELP {self.name} {self.description}",
                f"# TYPE {self.name} {self.kind}"]

    def samples(self) -> list[str]:
        with self._lock:
            items = list(self._values.items()) or [((), 0.0)] \
                if not self.tag_keys else list(self._values.items())
        return [f"{self.name}{self._fmt_labels(key)} {v}"
                for key, v in items]

    def expose(self) -> list[str]:
        return self.header() + self.samples()

    def snapshot(self) -> dict:
        """Pickle-friendly registry-delta entry (worker -> head)."""
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "desc": self.description, "tags": self.tag_keys,
                    "values": dict(self._values)}


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: dict | None = None):
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value
            self._dirty = True


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: dict | None = None):
        with self._lock:
            self._values[self._key(tags)] = float(value)
            self._dirty = True


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries=(0.1, 1, 10, 100),
                 tag_keys=()):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(boundaries)
        self._buckets: dict[tuple, list] = {}
        self._sums: dict[tuple, float] = {}
        self._counts: dict[tuple, int] = {}

    def observe(self, value: float, tags: dict | None = None):
        k = self._key(tags)
        with self._lock:
            b = self._buckets.setdefault(k, [0] * (len(self.boundaries) + 1))
            for i, bound in enumerate(self.boundaries):
                if value <= bound:
                    b[i] += 1
                    break
            else:
                b[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1
            self._dirty = True

    def samples(self) -> list[str]:
        lines: list[str] = []
        with self._lock:
            buckets = {k: list(v) for k, v in self._buckets.items()}
            sums, counts = dict(self._sums), dict(self._counts)
        for k, bks in buckets.items():
            lines += _histogram_sample_lines(
                self.name, self.boundaries, bks, sums[k], counts[k],
                self.tag_keys, k)
        return lines

    def expose(self) -> list[str]:
        return self.header() + self.samples()

    def snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "kind": self.kind,
                    "desc": self.description, "tags": self.tag_keys,
                    "boundaries": self.boundaries,
                    "buckets": {k: list(v)
                                for k, v in self._buckets.items()},
                    "sums": dict(self._sums),
                    "counts": dict(self._counts)}


def _histogram_sample_lines(name, boundaries, buckets, total_sum,
                            total_count, tag_keys, tag_values,
                            extra: dict | None = None) -> list[str]:
    """Exposition sample lines for ONE labeled histogram series."""
    keys = list(tag_keys) + list(extra or ())
    values = list(tag_values) + list((extra or {}).values())
    base = _fmt_label_pairs(keys, values)
    sep = "," if base else ""
    lines = []
    cum = 0
    for bound, n in zip(boundaries, buckets):
        cum += n
        lines.append(f'{name}_bucket{{{base}{sep}le="{bound}"}} {cum}')
    cum += buckets[-1]
    lines.append(f'{name}_bucket{{{base}{sep}le="+Inf"}} {cum}')
    suffix = "{" + base + "}" if base else ""
    lines.append(f"{name}_sum{suffix} {total_sum}")
    lines.append(f"{name}_count{suffix} {total_count}")
    return lines


def registry_delta() -> list[dict]:
    """Snapshots of metrics written since the last call (the worker->head
    shipping unit; cumulative values, so 'latest snapshot wins' merge)."""
    with _LOCK:
        metrics = list(_REGISTRY.values())
    out = []
    for m in metrics:
        if not m._dirty:
            continue
        m._dirty = False
        out.append(m.snapshot())
    return out


def _render_snapshot_series(snap: dict, extra: dict) -> list[str]:
    """Sample lines for one shipped worker-metric snapshot, with `extra`
    labels (WorkerId) appended to every series."""
    name, keys = snap["name"], tuple(snap["tags"])
    if snap["kind"] == "histogram":
        lines: list[str] = []
        for k, buckets in snap["buckets"].items():
            lines += _histogram_sample_lines(
                name, snap["boundaries"], buckets, snap["sums"][k],
                snap["counts"][k], keys, k, extra)
        return lines
    all_keys = list(keys) + list(extra)
    return [
        f"{name}{{{_fmt_label_pairs(all_keys, list(k) + list(extra.values()))}}} {v}"
        if all_keys else f"{name} {v}"
        for k, v in snap["values"].items()]


def _worker_metric_lines(seen: set) -> list[str]:
    """Merge worker-process registries (shipped as deltas on the event
    flush frames) into the scrape, tagged WorkerId."""
    from ray_tpu_torch.core.runtime import Runtime, current_runtime
    rt = current_runtime()
    if not isinstance(rt, Runtime):
        return []
    per_worker = rt.worker_metric_snapshots()
    by_name: dict[str, list] = {}
    headers: dict[str, dict] = {}
    for wid, metrics in per_worker.items():
        tag = {"WorkerId": wid.hex()}
        for snap in metrics.values():
            headers.setdefault(snap["name"], snap)
            by_name.setdefault(snap["name"], []).extend(
                _render_snapshot_series(snap, tag))
    lines: list[str] = []
    for name, series in by_name.items():
        if name not in seen:  # TYPE/HELP must appear once per name
            snap = headers[name]
            lines += [f"# HELP {name} {snap['desc']}",
                      f"# TYPE {name} {snap['kind']}"]
        lines += series
    return lines


_STAGE_BOUNDARIES = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                     5.0, 30.0)


def _task_pipeline_lines(rt) -> list[str]:
    """Per-stage task latency histograms + drop accounting, derived from
    the head's TaskEventStorage AT SCRAPE TIME (nothing aggregates on the
    hot path — the store keeps raw per-attempt events)."""
    lines: list[str] = []
    try:
        rt.sync_task_store()
        store = rt.task_store
        stages = store.stage_durations()
    except Exception:  # noqa: BLE001 — scrape must survive store churn
        return lines
    for stage, durations in stages.items():
        name = f"ray_tpu_task_{stage}_seconds"
        lines += [f"# HELP {name} task {stage} latency "
                  "(task-event pipeline, derived at scrape)",
                  f"# TYPE {name} histogram"]
        buckets = [0] * (len(_STAGE_BOUNDARIES) + 1)
        for d in durations:
            for i, bound in enumerate(_STAGE_BOUNDARIES):
                if d <= bound:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
        lines += _histogram_sample_lines(
            name, _STAGE_BOUNDARIES, buckets, sum(durations),
            len(durations), (), ())
    lines.append("# TYPE ray_tpu_task_events_dropped_total counter")
    lines.append('ray_tpu_task_events_dropped_total{site="source_rings"} '
                 f"{store.dropped_at_sources}")
    lines.append('ray_tpu_task_events_dropped_total{site="head_store"} '
                 f"{store.dropped_at_head}")
    return lines


def _system_lines() -> list[str]:
    """Built-in cluster gauges rendered at scrape time (parity: the ~90
    C++ metric defs, stats/metric_defs.cc — the high-signal subset)."""
    from ray_tpu_torch.core.runtime import Runtime, current_runtime
    rt = current_runtime()
    lines = []
    if not isinstance(rt, Runtime):
        return lines
    stats = rt.store.stats()
    rows = [
        ("ray_tpu_object_store_allocated_bytes", stats["allocated"]),
        ("ray_tpu_object_store_capacity_bytes", stats["capacity"]),
        ("ray_tpu_object_store_num_objects", stats["num_objects"]),
        ("ray_tpu_object_store_num_evictions", stats["num_evictions"]),
        ("ray_tpu_pending_tasks", len(rt.task_queue)),
        ("ray_tpu_alive_nodes",
         sum(1 for n in rt.nodes_table() if n["alive"])),
        ("ray_tpu_workers", len(rt.workers)),
        ("ray_tpu_actors_alive",
         sum(1 for a in rt.actors.values() if a.state == "alive")),
    ]
    for name, v in rows:
        lines += [f"# TYPE {name} gauge", f"{name} {v}"]
    lines += _task_pipeline_lines(rt)
    # The serve replica gauges join here with serve itself (ROADMAP queue
    # 1 item 7 (d)).
    return lines


def prometheus_text() -> str:
    with _LOCK:
        metrics = list(_REGISTRY.values())
    lines: list[str] = _system_lines()
    seen = set()
    for m in metrics:
        lines += m.expose()
        seen.add(m.name)
    try:
        lines += _worker_metric_lines(seen)
    except Exception:  # noqa: BLE001 — a torn snapshot must not 500 /metrics
        pass
    return "\n".join(lines) + "\n"

"""On-demand stack sampling for live processes (head and workers).

Parity: the reference dashboard's reporter module shells out to py-spy /
memray (`python/ray/dashboard/modules/reporter/`). Neither tool assumes a
TPU VM image, so the sampler here is built in: a thread walks
`sys._current_frames()` at a fixed rate and aggregates stacks — enough to
see where a worker (or the head control plane) spends host-side time,
with zero dependencies and no ptrace capability requirements. Exposed as
`ray_tpu_torch.util.state.profile_worker(...)` and the dashboard's
`/api/profile` route.
"""

from __future__ import annotations

import collections
import sys
import threading
import time


def sample_stacks(duration_s: float = 1.0, hz: float = 100.0,
                  depth: int = 24) -> dict:
    """Sample every thread's stack in THIS process for `duration_s`.

    Returns {"duration_s", "samples", "threads", "stacks": [{"stack":
    ["fn (file:line)", ... outermost last], "count"}]} sorted by count.
    """
    interval = 1.0 / max(hz, 1.0)
    counts: collections.Counter = collections.Counter()
    me = threading.get_ident()
    deadline = time.monotonic() + duration_s
    samples = 0
    thread_ids: set = set()
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            thread_ids.add(tid)
            stack = []
            f = frame
            while f is not None and len(stack) < depth:
                code = f.f_code
                stack.append(
                    f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}"
                    f":{f.f_lineno})")
                f = f.f_back
            counts[tuple(stack)] += 1
        samples += 1
        time.sleep(interval)
    return {
        "duration_s": duration_s,
        "samples": samples,
        "threads": len(thread_ids),
        "stacks": [{"stack": list(s), "count": c}
                   for s, c in counts.most_common()],
    }


def format_report(report: dict, top: int = 20) -> str:
    if "error" in report:
        return f"profiling failed: {report['error']}"
    total = max(report.get("samples", 1), 1)
    lines = [f"{report['samples']} samples over "
             f"{report['duration_s']:.1f}s across {report['threads']} "
             f"threads"]
    for entry in report["stacks"][:top]:
        pct = 100.0 * entry["count"] / total
        lines.append(f"\n{pct:5.1f}%  ({entry['count']} samples)")
        for frame in entry["stack"]:
            lines.append(f"        {frame}")
    return "\n".join(lines)

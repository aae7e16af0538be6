"""Export API: durable JSONL stream of cluster state transitions.

Parity: reference `src/ray/protobuf/export_api/` + `src/ray/util/event.h:142`
(RayExportEvent/EventManager) — a file-based event stream external systems
tail for task/actor/node lifecycle changes, independent of the bounded
in-memory task-event ring. Enabled with the `export_events` config flag;
files land under `<session>/export_events/events_<kind>.jsonl`.
"""

from __future__ import annotations

import json
import os
import threading
import time


class ExportEventWriter:
    """Appends one JSON object per line, per event kind, flushed on every
    emit (tail -f friendly; emit volume is control-plane scale)."""

    def __init__(self, session_dir: str):
        self.dir = os.path.join(session_dir, "export_events")
        os.makedirs(self.dir, exist_ok=True)
        self._files: dict = {}
        self._lock = threading.Lock()

    def emit(self, kind: str, **fields):
        row = {"timestamp": time.time(), "kind": kind, **fields}
        line = json.dumps(row, default=repr) + "\n"
        with self._lock:
            f = self._files.get(kind)
            if f is None:
                f = open(os.path.join(self.dir, f"events_{kind}.jsonl"),
                         "a", buffering=1)
                self._files[kind] = f
            try:
                f.write(line)
            except (OSError, ValueError):
                pass

    def close(self):
        with self._lock:
            for f in self._files.values():
                try:
                    f.close()
                except OSError:
                    pass
            self._files.clear()

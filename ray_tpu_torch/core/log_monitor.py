"""Log monitor: stream worker stdout/stderr to the driver.

Parity: reference `python/ray/_private/log_monitor.py` — a per-node tailer
publishing worker log lines so the driver prints them (`log_to_driver`).
Here the head-side monitor tails `<session>/logs/worker-*.out` (head-node
workers; remote nodes keep their own log dirs) and prints new lines
prefixed with the worker id, reference-style `(worker-xxxx) ...`.
"""

from __future__ import annotations

import glob
import os
import sys
import threading
import time


class LogMonitor:
    def __init__(self, logs_dir: str, poll_interval_s: float = 0.25,
                 out=None):
        self.logs_dir = logs_dir
        self.poll = poll_interval_s
        self.out = out or sys.stdout
        self._offsets: dict[str, int] = {}
        self._partial: dict[str, bytes] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-log-monitor")

    def start(self):
        # Existing content predates this driver: start at EOF per file.
        for path in glob.glob(os.path.join(self.logs_dir, "worker-*.out")):
            try:
                self._offsets[path] = os.path.getsize(path)
            except OSError:
                pass
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._scan()
            except Exception:  # noqa: BLE001 — monitoring must not die
                pass
            time.sleep(self.poll)
        self._scan()  # final drain

    def _scan(self):
        for path in glob.glob(os.path.join(self.logs_dir, "worker-*.out")):
            off = self._offsets.get(path, 0)
            try:
                size = os.path.getsize(path)
                if size <= off:
                    continue
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(size - off)
            except OSError:
                continue
            self._offsets[path] = off + len(data)
            tag = os.path.basename(path)[len("worker-"):-len(".out")]
            # Split at the BYTE level and decode whole lines only — a
            # multi-byte character straddling two reads must not be
            # decoded in halves.
            raw = self._partial.pop(path, b"") + data
            lines = raw.split(b"\n")
            if not raw.endswith(b"\n"):
                self._partial[path] = lines.pop()
            for line in lines:
                if line:
                    try:
                        self.out.write(
                            f"(worker-{tag}) "
                            f"{line.decode(errors='replace')}\n")
                    except (OSError, ValueError):
                        return
        try:
            self.out.flush()
        except (OSError, ValueError):
            pass

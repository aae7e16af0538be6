"""One deadline/backoff-with-jitter policy for the data/control planes.

Parity: reference `src/ray/common/ray_config_def.h` backoff knobs +
`retryable_grpc_client.h` — ONE policy object instead of the scattered
ad-hoc `time.sleep(0.5)` / `delay = min(delay * 2, ...)` constants that
had grown across the peer dial, the agent's head reconnect, and objxfer's
created-but-unsealed (status-2) poll. Every retry loop in core/ sleeps
through a `Backoff` so the cadence is config-tunable in one place and
jittered (synchronized retry storms from N processes hammering one
restarted peer are the failure mode jitter exists for).

`ray_tpu_torch.util.retry` remains the HTTP/cloud-API wrapper (attempt-count
shaped); this module is deadline-shaped — data-plane loops know how long
the operation may take, not how many tries it deserves.
"""

from __future__ import annotations

import random
import time


def policy_from_config(cfg=None):
    """(base_s, cap_s, jitter_frac) from the config table (falls back to
    the defaults when the config is not importable — bare unit tests)."""
    if cfg is None:
        try:
            from ray_tpu_torch.core.config import get_config
            cfg = get_config()
        except Exception:  # noqa: BLE001 — config not importable
            return 0.05, 2.0, 0.2
    return (cfg.retry_backoff_base_s, cfg.retry_backoff_cap_s,
            cfg.retry_backoff_jitter)


class Backoff:
    """Capped exponential backoff with jitter against a deadline.

        bo = Backoff(deadline_s=grace)          # config-tuned cadence
        while not bo.expired():
            if try_once():
                return
            if not bo.sleep():
                break                            # deadline exhausted

    `sleep()` waits the next interval (never past the deadline) and
    returns False once the deadline is exhausted. Each interval is
    `base * 2^k`, capped at `cap`, then jittered by ±`jitter` fraction —
    all three default from the `retry_backoff_*` config knobs.
    """

    def __init__(self, base_s: float | None = None,
                 cap_s: float | None = None,
                 jitter: float | None = None,
                 deadline_s: float | None = None,
                 rng: random.Random | None = None):
        cfg_base, cfg_cap, cfg_jitter = policy_from_config()
        self.base_s = cfg_base if base_s is None else base_s
        self.cap_s = cfg_cap if cap_s is None else cap_s
        self.jitter = cfg_jitter if jitter is None else jitter
        self._rng = rng or random
        self._attempt = 0
        self._deadline = (None if deadline_s is None
                          else time.monotonic() + deadline_s)

    def reset(self) -> None:
        """Back to the base interval (progress was made)."""
        self._attempt = 0

    def expired(self) -> bool:
        return (self._deadline is not None
                and time.monotonic() >= self._deadline)

    def remaining(self) -> float:
        if self._deadline is None:
            return float("inf")
        return max(0.0, self._deadline - time.monotonic())

    def next_interval(self) -> float:
        """The next sleep length (advances the attempt counter)."""
        d = min(self.base_s * (2 ** self._attempt), self.cap_s)
        self._attempt += 1
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def sleep(self) -> bool:
        """Sleep the next interval, clipped to the deadline. Returns
        False when the deadline is exhausted (nothing left to wait)."""
        d = self.next_interval()
        if self._deadline is not None:
            left = self._deadline - time.monotonic()
            if left <= 0:
                return False
            d = min(d, left)
        time.sleep(d)
        return not self.expired()


def call_with_backoff(fn, deadline_s: float, retry_on=(OSError,),
                      base_s: float | None = None,
                      cap_s: float | None = None):
    """Run `fn()` until it returns without raising `retry_on`, sleeping a
    jittered capped-exponential interval between attempts, for at most
    `deadline_s`. The final failure propagates unchanged."""
    bo = Backoff(base_s=base_s, cap_s=cap_s, deadline_s=deadline_s)
    while True:
        try:
            return fn()
        except retry_on:
            if not bo.sleep():
                raise

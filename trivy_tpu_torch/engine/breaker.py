"""Device circuit breaker: stop feeding a sick device, re-probe on a timer.

A device that starts failing (lost TPU, wedged runtime, persistent OOM)
fails every batch sent to it, and each failure costs a full degraded
re-run on the host.  The breaker converts "N failures in a window" into
a *routing* decision: while OPEN the scheduler skips the device engine
entirely and goes straight to the host DFA path, and after a cooldown
the breaker goes HALF-OPEN — exactly one probe batch is allowed through;
success re-closes, failure re-opens and restarts the cooldown.

States (exported as trivy_tpu_device_breaker_state):

    0 closed     healthy; failures counted in a sliding window
    1 half-open  cooldown elapsed; one probe batch in flight
    2 open       tripped; all batches degrade to host until cooldown

Thread model: record_success/record_failure run on the engine-owner
thread; allow() also runs there, but snapshot() is read by /metrics,
/readyz, and flight captures from server threads — hence the lock.
Transitions invoke ``on_transition(old, new, reason)`` synchronously
*outside* the lock (listeners write gatelog/metrics, which take their
own locks).

Copied from `trivy_tpu/engine/breaker.py`; the port imports nothing
from the JAX package, so it keeps its own copy of this jax-free module.
"""

from __future__ import annotations

import time
from typing import Callable

from trivy_tpu_torch import lockcheck

STATE_CODES = {"closed": 0, "half-open": 1, "open": 2}


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 3,
        window_s: float = 30.0,
        cooldown_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[str, str, str], None] | None = None,
    ):
        self._lock = lockcheck.make_lock("breaker")
        self.failure_threshold = max(1, int(failure_threshold))
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.on_transition = on_transition
        self.state = "closed"  # owner: _lock
        self._failures: list[float] = []  # owner: _lock
        self._opened_at = 0.0  # owner: _lock
        self._probing = False  # owner: _lock
        self.opened_total = 0  # owner: _lock
        self.reclosed_total = 0  # owner: _lock
        self.probes_total = 0  # owner: _lock

    # -- engine-owner side -------------------------------------------------

    def allow(self) -> bool:
        """May the next batch use the device?  OPEN converts to HALF-OPEN
        once the cooldown elapses, admitting exactly one probe."""
        fired: tuple[str, str, str] | None = None
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "half-open":
                # One probe at a time: batches behind the probe degrade.
                if self._probing:
                    return False
                self._probing = True
                self.probes_total += 1
                return True
            if self._clock() - self._opened_at >= self.cooldown_s:
                fired = (self.state, "half-open", "cooldown elapsed")
                self.state = "half-open"
                self._probing = True
                self.probes_total += 1
        if fired is not None:
            self._notify(*fired)
            return True
        return False

    def record_success(self) -> None:
        fired: tuple[str, str, str] | None = None
        with self._lock:
            if self.state == "half-open":
                fired = (self.state, "closed", "probe succeeded")
                self.state = "closed"
                self._probing = False
                self.reclosed_total += 1
            del self._failures[:]
        if fired is not None:
            self._notify(*fired)

    def record_failure(self) -> None:
        fired: tuple[str, str, str] | None = None
        now = self._clock()
        with self._lock:
            if self.state == "half-open":
                fired = (self.state, "open", "probe failed")
                self.state = "open"
                self._probing = False
                self._opened_at = now
                self.opened_total += 1
            elif self.state == "closed":
                self._failures.append(now)
                cutoff = now - self.window_s
                self._failures[:] = [t for t in self._failures if t >= cutoff]
                if len(self._failures) >= self.failure_threshold:
                    fired = (
                        self.state,
                        "open",
                        f"{len(self._failures)} failures in "
                        f"{self.window_s:g}s",
                    )
                    self.state = "open"
                    self._opened_at = now
                    self.opened_total += 1
                    del self._failures[:]
        if fired is not None:
            self._notify(*fired)

    # -- observer side -----------------------------------------------------

    def state_code(self) -> int:
        with self._lock:
            return STATE_CODES[self.state]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "state_code": STATE_CODES[self.state],
                "failures_in_window": len(self._failures),
                "failure_threshold": self.failure_threshold,
                "window_s": self.window_s,
                "cooldown_s": self.cooldown_s,
                # How long until an open breaker admits its half-open
                # probe (0 when closed, or already probe-eligible).  The
                # readiness surface turns this into a Retry-After hint.
                "cooldown_remaining_s": (
                    round(
                        max(
                            0.0,
                            self._opened_at
                            + self.cooldown_s
                            - self._clock(),
                        ),
                        3,
                    )
                    if self.state == "open"
                    else 0.0
                ),
                "opened_total": self.opened_total,
                "reclosed_total": self.reclosed_total,
                "probes_total": self.probes_total,
            }

    def _notify(self, old: str, new: str, reason: str) -> None:
        fn = self.on_transition
        if fn is None:
            return
        try:
            fn(old, new, reason)
        except Exception:  # graftlint: swallow(listener must not poison routing)
            pass

"""Step health bookkeeping (after the reference's ``service/health.py``).

In the port a failed step raises; :class:`HealthMonitor` only records the
outcomes for ``stats()``.  The reference's passthrough degradation (and
its ``degraded`` state) is not ported yet, so after
``MAX_CONSECUTIVE_FAILURES`` failed steps in a row the state is ``down``.
"""

from __future__ import annotations

import enum
import logging

log = logging.getLogger("vst.health")

MAX_CONSECUTIVE_FAILURES = 3


class EngineHealth(enum.Enum):
    OK = "ok"
    DOWN = "down"


class HealthMonitor:
    def __init__(self):
        self.state = EngineHealth.OK
        self.consecutive_failures = 0
        self.total_failures = 0
        self.last_error: str | None = None

    def record_success(self):
        self.consecutive_failures = 0
        self.state = EngineHealth.OK

    def record_failure(self, err: BaseException):
        self.consecutive_failures += 1
        self.total_failures += 1
        self.last_error = f"{type(err).__name__}: {err}"
        log.warning("pipeline step failed (%d consecutive): %s",
                    self.consecutive_failures, self.last_error)
        if self.consecutive_failures >= MAX_CONSECUTIVE_FAILURES:
            self.state = EngineHealth.DOWN

    def snapshot(self) -> dict:
        return {
            "state": self.state.value,
            "consecutive_failures": self.consecutive_failures,
            "total_failures": self.total_failures,
            "last_error": self.last_error,
        }

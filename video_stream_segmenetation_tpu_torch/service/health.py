"""Failure detection and graceful degradation (port of the reference's
``service/health.py``).

:class:`HealthMonitor` counts consecutive failed steps; after
``max_consecutive_failures`` of them the engine is DEGRADED and serves
passthrough frames (output == input) instead of failing the batch.  Every
``recovery_probe_s`` seconds in that state one step runs the real
pipeline again (:attr:`HealthMonitor.should_probe`); its success returns
the engine to OK.
"""

from __future__ import annotations

import enum
import logging
import time

log = logging.getLogger("vst.health")


class EngineHealth(enum.Enum):
    OK = "ok"
    DEGRADED = "degraded"  # serving passthrough


class HealthMonitor:
    def __init__(self, max_consecutive_failures: int = 3, recovery_probe_s: float = 5.0):
        self.max_consecutive_failures = max_consecutive_failures
        self.recovery_probe_s = recovery_probe_s
        self.state = EngineHealth.OK
        self.consecutive_failures = 0
        self.total_failures = 0
        self.last_error: str | None = None
        self._degraded_at = 0.0

    def record_success(self):
        self.consecutive_failures = 0
        if self.state is EngineHealth.DEGRADED:
            log.info("engine recovered; leaving degraded mode")
        self.state = EngineHealth.OK

    def record_failure(self, err: BaseException):
        self.consecutive_failures += 1
        self.total_failures += 1
        self.last_error = f"{type(err).__name__}: {err}"
        log.warning("pipeline step failed (%d consecutive): %s",
                    self.consecutive_failures, self.last_error, exc_info=err)
        if self.consecutive_failures >= self.max_consecutive_failures:
            if self.state is not EngineHealth.DEGRADED:
                log.error("entering DEGRADED (passthrough) mode")
            self.state = EngineHealth.DEGRADED
            self._degraded_at = time.monotonic()

    @property
    def should_probe(self) -> bool:
        """In DEGRADED mode, retry the real pipeline occasionally."""
        return (self.state is EngineHealth.DEGRADED
                and time.monotonic() - self._degraded_at >= self.recovery_probe_s)

    @property
    def serve_passthrough(self) -> bool:
        """DEGRADED and not yet time to probe: the step is skipped."""
        return self.state is EngineHealth.DEGRADED and not self.should_probe

    def snapshot(self) -> dict:
        return {
            "state": self.state.value,
            "consecutive_failures": self.consecutive_failures,
            "total_failures": self.total_failures,
            "last_error": self.last_error,
        }

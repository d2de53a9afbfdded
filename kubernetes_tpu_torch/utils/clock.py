"""Real and fake clocks (reference: k8s.io/utils/clock — the fake clock is injected
into the scheduler the same way scheduler.WithClock does, pkg/scheduler/scheduler.go:233)."""

from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """Manually-stepped clock for deterministic tests."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._cond = threading.Condition()

    def now(self) -> float:
        with self._cond:
            return self._now

    def step(self, seconds: float) -> None:
        with self._cond:
            self._now += seconds
            self._cond.notify_all()

    def sleep(self, seconds: float) -> None:
        with self._cond:
            deadline = self._now + seconds
            while self._now < deadline:
                self._cond.wait(timeout=1.0)

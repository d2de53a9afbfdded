"""Lightweight spans with threshold logging + structured JSON logging.

The counterpart of `kubernetes_tpu/utils/tracing.py`. Reference:
k8s.io/utils/trace (the scheduler's utiltrace steps with a 100ms log
threshold — schedule_one.go:411) and component-base/logs (klog text/JSON
backends). OTel export is out of scope; the span model matches utiltrace so
call sites read the same. server/rest.py's /configz route serves
configz_snapshot().
"""

from __future__ import annotations

import json
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Step:
    msg: str
    at: float
    fields: Dict[str, Any] = field(default_factory=dict)


class Trace:
    """utiltrace.Trace: named steps; logged only if total exceeds threshold."""

    def __init__(self, name: str, logger: Optional["StructuredLogger"] = None,
                 clock=None, **fields):
        self.name = name
        self.fields = fields
        self.clock = clock
        self.logger = logger or default_logger
        self.start = self._now()
        self.steps: List[Step] = []
        self.end: Optional[float] = None

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else time.perf_counter()

    def step(self, msg: str, **fields) -> None:
        self.steps.append(Step(msg, self._now(), fields))

    def duration(self) -> float:
        return (self.end if self.end is not None else self._now()) - self.start

    def log_if_long(self, threshold: float) -> bool:
        """Log the whole trace when total duration exceeds threshold
        (utiltrace LogIfLong). Returns whether it logged."""
        self.end = self._now()
        total = self.end - self.start
        if total < threshold:
            return False
        prev = self.start
        steps = []
        for s in self.steps:
            steps.append({"msg": s.msg, "ms": round((s.at - prev) * 1000, 2),
                          **s.fields})
            prev = s.at
        self.logger.info(f"Trace {self.name!r} exceeded threshold",
                         total_ms=round(total * 1000, 2),
                         threshold_ms=round(threshold * 1000, 2),
                         steps=steps, **self.fields)
        # unified trace timeline: a slow trace's steps also land
        # on the armed trace buffer, so serial-path spikes show on the same
        # Perfetto timeline as the batch slices. Slow path only (we already
        # crossed the logging threshold), lazy import (no obs dependency on
        # the fast path), and perf_counter-domain traces only — a custom
        # clock has no place on the buffer's axis.
        from ..obs import tracebuf

        if tracebuf.ACTIVE is not None and self.clock is None:
            at = self.start
            for s in self.steps:
                tracebuf.ACTIVE.note_span(
                    "slowtrace", f"{self.name}:{s.msg}", at, s.at,
                    cat="slowtrace", args=dict(s.fields) or None)
                at = s.at
        return True

    def __enter__(self) -> "Trace":
        return self

    def __exit__(self, *exc) -> None:
        self.end = self._now()


class StructuredLogger:
    """klog-style leveled logger with a JSON backend (component-base/logs
    json format). Writes one JSON object per line."""

    LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

    def __init__(self, component: str, stream=None, level: str = "info"):
        self.component = component
        self.stream = stream if stream is not None else sys.stderr
        self.level = self.LEVELS[level]
        self._lock = threading.Lock()

    def _emit(self, severity: str, msg: str, kv: Dict[str, Any]) -> None:
        if self.LEVELS[severity] < self.level:
            return
        record = {"ts": time.time(), "v": severity, "component": self.component,
                  "msg": msg, **kv}
        line = json.dumps(record, default=str)
        with self._lock:
            self.stream.write(line + "\n")

    def debug(self, msg: str, **kv) -> None:
        self._emit("debug", msg, kv)

    def info(self, msg: str, **kv) -> None:
        self._emit("info", msg, kv)

    def warning(self, msg: str, **kv) -> None:
        self._emit("warning", msg, kv)

    def error(self, msg: str, **kv) -> None:
        self._emit("error", msg, kv)


default_logger = StructuredLogger("kubernetes-tpu")


# -- configz (component-base/configz) ----------------------------------------

_configz_lock = threading.Lock()
_configz: Dict[str, Any] = {}


def register_config(name: str, config: Any) -> None:
    """Expose a component's live config at /configz (configz.InstallHandler)."""
    with _configz_lock:
        _configz[name] = config


def configz_snapshot() -> Dict[str, Any]:
    with _configz_lock:
        return dict(_configz)

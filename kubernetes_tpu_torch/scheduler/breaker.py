"""Solver circuit breaker: degrade to the simplest solver under repeated
solver failures, recover through half-open probes.

The counterpart of `kubernetes_tpu/scheduler/breaker.py`. The batched
pipeline's solvers form a reliability ladder: the fast path (waterfill,
kernel C, and propose-and-repair, kernels C and D) is held against the exact
scan (kernel A), the semantics oracle. The breaker applies the standard
circuit-breaker state machine to solver CHOICE:

  CLOSED     the configured solver runs; consecutive failures are counted.
  OPEN       after `threshold` consecutive failures the breaker trips: every
             batch for `cooldown_s` runs the DEGRADED solver (the scan).
  HALF_OPEN  cooldown expired: ONE batch probes the configured solver.
             Success closes the breaker (a recovery); failure re-opens it
             for another cooldown.

The scheduler calls effective_solver() once per batch (which performs the
OPEN -> HALF_OPEN transition on cooldown expiry) and reports the outcome of
the solve with record_success()/record_failure(). Failures of the DEGRADED
solver are counted but never change state: there is nothing further to
degrade to, and the pods requeue with backoff either way. The state gauge
and the Warning event come with the metrics (ROADMAP.md queue 1 item 7d).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..utils import Clock

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

# the degradation ladder: every fast path falls back to the exact scan
# solver (the oracle); "exact" has nowhere further to go — the breaker still
# counts and reports, so a failing oracle is at least visible
DEGRADED = {
    "fast": "exact",
    "auto": "exact",
    "native": "exact",
    "auction": "exact",
    "sinkhorn": "exact",
    "exact": "exact",
}

# which EXECUTED path (BatchScheduler._solve_path) represents the preferred
# mode's fast path: a constrained batch under an exact/native/transport mode
# runs the scan regardless of the breaker, and its outcome says NOTHING
# about the failing fast kernel — crediting it to the mode would falsely
# close (or trip) the breaker
REPRESENTATIVE = {
    "fast": "fast",
    "auto": "fast",
    "native": "native",
    "auction": "auction",
    "sinkhorn": "sinkhorn",
    "exact": "exact",
}

# the fast MODE has two paths: the constraint-free waterfill ("fast") and
# the constrained propose-and-repair pipeline ("repair", models/repair.py).
# A failure of EITHER is a failure of the mode under protection, so both
# degrade to the exact scan oracle through the same trip/cooldown/half-open
# ladder, and a successful repair batch is a genuine probe of the mode.
FAST_PATHS = ("fast", "repair")


def path_matches_mode(used: str, preferred: str) -> bool:
    """True when the executed solver path `used` exercised the preferred
    MODE's fast path (the thing the breaker is protecting)."""
    rep = REPRESENTATIVE.get(preferred, preferred)
    if rep == "fast":
        return used in FAST_PATHS
    return used == rep


class SolverCircuitBreaker:
    def __init__(self, clock: Optional[Clock] = None, threshold: int = 3,
                 cooldown_s: float = 30.0):
        self.clock = clock or Clock()
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = CLOSED
        self.consecutive_failures = 0
        self.trips = 0  # CLOSED/HALF_OPEN -> OPEN transitions
        self.recoveries = 0  # HALF_OPEN -> CLOSED transitions
        self.failures_total = 0  # every recorded solver failure
        self.degraded_failures = 0  # failures of the degraded solver itself
        self._opened_at = 0.0

    # -- per-batch protocol ----------------------------------------------------

    def effective_solver(self, preferred: str) -> str:
        """The solver MODE this batch should use. Performs the OPEN ->
        HALF_OPEN transition when the cooldown has expired, so the very next
        batch is the probe. CLOSED and HALF_OPEN both run the preferred
        mode (a HALF_OPEN batch IS the probe)."""
        if self.state == OPEN:
            if self.clock.now() - self._opened_at >= self.cooldown_s:
                self.state = HALF_OPEN
            else:
                return DEGRADED.get(preferred, "exact")
        return preferred

    def record_success(self, used: str, preferred: str) -> None:
        """`used` is the EXECUTED solver path (BatchScheduler._solve_path),
        not the mode label: a constrained batch routed to the scan proves
        nothing about the preferred fast path, so it neither closes a
        HALF_OPEN breaker nor resets the failure streak — the breaker keeps
        probing until a batch genuinely exercises the protected path."""
        if not path_matches_mode(used, preferred):
            return
        if self.state == HALF_OPEN:
            self.state = CLOSED
            self.recoveries += 1
        self.consecutive_failures = 0

    def record_failure(self, used: str, preferred: str) -> bool:
        """Returns True when THIS failure tripped the breaker. Failures of
        any path OTHER than the preferred mode's (the degraded scan while
        OPEN, or a constrained batch's scan while CLOSED) are counted but
        never move the state machine — there is nothing to degrade to, and
        tripping on them would just relabel the same failing path."""
        self.failures_total += 1
        if not path_matches_mode(used, preferred):
            self.degraded_failures += 1
            return False
        self.consecutive_failures += 1
        if (self.state == HALF_OPEN
                or self.consecutive_failures >= self.threshold):
            tripped = self.state != OPEN
            self.state = OPEN
            self._opened_at = self.clock.now()
            if tripped:
                self.trips += 1
            return tripped
        return False

    # -- observability ---------------------------------------------------------

    @property
    def code(self) -> int:
        """Gauge encoding: 0 closed, 1 half-open, 2 open."""
        return _STATE_CODE[self.state]

    def describe(self) -> Dict:
        return {
            "state": self.state,
            "consecutive_failures": self.consecutive_failures,
            "failures_total": self.failures_total,
            "degraded_failures": self.degraded_failures,
            "trips": self.trips,
            "recoveries": self.recoveries,
            "threshold": self.threshold,
            "cooldown_s": self.cooldown_s,
        }

"""The port's solver circuit breaker (scheduler/breaker.py) against the JAX
package's: the same seeded event sequences (effective_solver calls, clock
steps, successes and failures of every executed path under every mode) drive
both, with a FakeClock each; every return value and describe() must agree
after every event.
"""

import numpy as np
import pytest

from kubernetes_tpu.scheduler import breaker as jbr
from kubernetes_tpu.utils import FakeClock as JFakeClock
from kubernetes_tpu_torch.scheduler import breaker as tbr
from kubernetes_tpu_torch.utils import FakeClock as TFakeClock

MODES = ("fast", "auto", "exact", "native", "auction", "sinkhorn")
PATHS = ("fast", "repair", "exact", "native", "auction", "sinkhorn")


def test_tables_match_jax():
    assert tbr.DEGRADED == jbr.DEGRADED
    assert tbr.REPRESENTATIVE == jbr.REPRESENTATIVE
    assert tbr.FAST_PATHS == jbr.FAST_PATHS
    for used in PATHS:
        for mode in MODES:
            assert tbr.path_matches_mode(used, mode) == jbr.path_matches_mode(used, mode)


@pytest.mark.parametrize("seed", range(12))
def test_state_machine_matches_jax(seed):
    rng = np.random.default_rng(seed)
    threshold = int(rng.integers(1, 5))
    cooldown = float(rng.choice([0.0, 1.0, 5.0, 30.0]))
    jc, tc = JFakeClock(), TFakeClock()
    jb = jbr.SolverCircuitBreaker(clock=jc, threshold=threshold, cooldown_s=cooldown)
    tb = tbr.SolverCircuitBreaker(clock=tc, threshold=threshold, cooldown_s=cooldown)
    mode = str(rng.choice(["fast", "auto"] if seed % 3 else MODES))
    for _ in range(200):
        op = int(rng.integers(0, 4))
        if op == 0:
            assert tb.effective_solver(mode) == jb.effective_solver(mode)
        elif op == 1:
            dt = float(rng.choice([0.5, 2.0, 10.0, 40.0]))
            jc.step(dt)
            tc.step(dt)
        else:
            # failures are likelier on the protected path, so the breaker trips
            used = str(rng.choice(PATHS, p=[0.4, 0.2, 0.2, 0.1, 0.05, 0.05]))
            if op == 2:
                tb.record_success(used, mode)
                jb.record_success(used, mode)
            else:
                assert tb.record_failure(used, mode) == jb.record_failure(used, mode)
        assert tb.describe() == jb.describe()
        assert tb.code == jb.code


def test_trip_cooldown_probe_and_recovery():
    clock = TFakeClock()
    b = tbr.SolverCircuitBreaker(clock=clock, threshold=2, cooldown_s=10.0)
    assert not b.record_failure("fast", "fast")
    assert b.record_failure("repair", "fast")  # repair is the fast mode too
    assert b.state == tbr.OPEN and b.effective_solver("fast") == "exact"
    b.record_success("exact", "fast")  # the degraded scan proves nothing
    assert b.state == tbr.OPEN
    clock.step(10.0)
    assert b.effective_solver("fast") == "fast" and b.state == tbr.HALF_OPEN
    b.record_success("fast", "fast")
    assert b.state == tbr.CLOSED and b.recoveries == 1 and b.trips == 1

"""Thread-leak detection — the goleak analog for a threaded runtime.

reference: test/integration/framework/goleak.go (go.uber.org/goleak) — every
integration test asserts the goroutines it started are gone when it ends.
Here components run daemon threads (controllers, schedulers, kubelets, watch
pumps); a stop() that forgets to join leaks a thread that keeps mutating the
store under later tests. Wrap a component lifecycle in
`assert_no_thread_leaks()` to pin clean shutdown.

The counterpart of `kubernetes_tpu/utils/leakcheck.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterable


@contextmanager
def assert_no_thread_leaks(grace: float = 3.0, allow: Iterable[str] = ()):
    """Fails if threads started inside the block outlive it (after a grace
    period for in-flight shutdowns, goleak's retry loop). `allow` names
    substrings of expected survivors (e.g. process-wide singletons)."""
    before = set(threading.enumerate())
    yield
    deadline = time.time() + grace
    leaked = []
    while True:
        leaked = [
            t for t in threading.enumerate()
            if t not in before and t.is_alive()
            and not any(a in (t.name or "") for a in allow)
        ]
        if not leaked or time.time() > deadline:
            break
        time.sleep(0.05)
    if leaked:
        raise AssertionError(
            "leaked threads: " + ", ".join(sorted(t.name for t in leaked)))

"""Lease-based leader election (control-plane HA).

reference: staging/src/k8s.io/client-go/tools/leaderelection/leaderelection.go:31-87
— acquire/renew a coordination Lease; the standby takes over when the holder
stops renewing for LeaseDuration (~15s default, scheduler server.go:281).

The counterpart of `kubernetes_tpu/utils/leaderelection.py`: the same
behaviour, names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..api.types import ObjectMeta, new_uid
from ..api.workloads import Lease
from ..store import AlreadyExistsError, APIStore, ConflictError, NotFoundError
from .clock import Clock


class LeaderElector:
    def __init__(self, store: APIStore, lock_name: str, identity: str,
                 lease_duration: float = 15.0, renew_deadline: float = 10.0,
                 retry_period: float = 2.0, namespace: str = "kube-system",
                 clock: Optional[Clock] = None,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None):
        self.store = store
        self.lock_name = lock_name
        self.identity = identity
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.namespace = namespace
        self.clock = clock or Clock()
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self.is_leader = False
        self._last_renew = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def _key(self) -> str:
        return f"{self.namespace}/{self.lock_name}"

    def try_acquire_or_renew(self) -> bool:
        """One election round; returns True while holding the lock."""
        now = self.clock.now()
        try:
            lease: Lease = self.store.get("leases", self._key)
        except NotFoundError:
            lease = Lease(
                metadata=ObjectMeta(name=self.lock_name, namespace=self.namespace, uid=new_uid()),
                holder_identity=self.identity,
                lease_duration_seconds=int(self.lease_duration),
                acquire_time=now, renew_time=now,
            )
            try:
                self.store.create("leases", lease)
                self._became(True)
                return True
            except AlreadyExistsError:
                return self.try_acquire_or_renew()

        # empty holder = voluntarily released; never treat it as alive
        holder_alive = bool(lease.holder_identity) and \
            (now - lease.renew_time) < self.lease_duration
        if lease.holder_identity != self.identity and holder_alive:
            self._became(False)
            return False

        class _LostRace(Exception):
            pass

        def mutate(obj: Lease) -> Lease:
            # guaranteed_update re-reads on conflict: liveness MUST be
            # re-evaluated on the fresh object, or two expired-holder observers
            # would both seize the lock (split-brain). client-go re-checks
            # observedRecord on every attempt the same way.
            fresh_alive = bool(obj.holder_identity) and \
                (self.clock.now() - obj.renew_time) < self.lease_duration
            if obj.holder_identity != self.identity and fresh_alive:
                raise _LostRace()
            if obj.holder_identity != self.identity:
                obj.acquire_time = now
            obj.holder_identity = self.identity
            obj.renew_time = now
            return obj

        try:
            self.store.guaranteed_update("leases", self._key, mutate)
            self._last_renew = now
            self._became(True)
            return True
        except _LostRace:
            self._became(False)  # someone else demonstrably holds the lock
            return False
        except (ConflictError, NotFoundError):
            # transient renew failure: a leader keeps leading until the
            # renewDeadline elapses (client-go renew-loop tolerance)
            if self.is_leader and now - self._last_renew <= self.renew_deadline:
                return False
            self._became(False)
            return False

    def _became(self, leader: bool) -> None:
        if leader and not self.is_leader:
            self.is_leader = True
            if self.on_started_leading:
                self.on_started_leading()
        elif not leader and self.is_leader:
            self.is_leader = False
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def run(self) -> None:
        """Blocking acquire/renew loop (LeaderElector.Run)."""
        while not self._stop.is_set():
            self.try_acquire_or_renew()
            self._stop.wait(self.retry_period)  # wakes immediately on stop()
        if self.is_leader:
            self.release()

    def start(self) -> "LeaderElector":
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def release(self) -> None:
        """Voluntarily give up the lock (graceful shutdown). The holder's
        components stop first and the lease goes after: cleared first, a
        standby could lead while they still write (the JAX package clears
        first, ROADMAP.md queue 3)."""
        self._became(False)
        try:
            def mutate(obj: Lease) -> Lease:
                if obj.holder_identity == self.identity:
                    obj.holder_identity = ""
                    obj.renew_time = 0.0
                return obj

            self.store.guaranteed_update("leases", self._key, mutate)
        except NotFoundError:
            pass

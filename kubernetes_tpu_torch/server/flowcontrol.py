"""API Priority and Fairness (APF) — apiserver request flow control.

reference: staging/src/k8s.io/apiserver/pkg/util/flowcontrol (the APF
dispatcher) and the flowcontrol.apiserver.k8s.io API group
(PriorityLevelConfiguration + FlowSchema). The carried subset:

  - PriorityLevel: a seat limit (assured concurrency) + a bounded FIFO queue
    with a wait deadline. Requests beyond seats wait; beyond queue length or
    deadline they get 429 + Retry-After (the reference's reject verdict).
  - FlowSchema: ordered match rules (user / group / verb / resource
    wildcards) -> priority level; first match wins, like the reference's
    matchingPrecedence ordering.
  - Exempt levels dispatch immediately (system:masters traffic must never be
    starved by a misbehaving workload — the `exempt` level).

Long-running requests (watches) are NOT seat-accounted, mirroring the
reference's longRunningRequestCheck: a watch holds its connection for
minutes, and counting it against seats would wedge the level.

The fair-queuing refinement (shuffle sharding over N queues per level) is
collapsed to one FIFO per level: the fairness unit here is the level, which
is the property the tests (and the 429 contract) depend on.

The counterpart of `kubernetes_tpu/server/flowcontrol.py`: the same
behaviour, names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class PriorityLevel:
    """Seat-limited dispatch with a bounded wait queue."""

    def __init__(self, name: str, seats: int = 10, queue_length: int = 50,
                 queue_timeout: float = 5.0, exempt: bool = False):
        self.name = name
        self.seats = seats
        self.queue_length = queue_length
        self.queue_timeout = queue_timeout
        self.exempt = exempt
        self._cond = threading.Condition()
        self.inflight = 0
        self.waiting = 0
        self.rejected = 0  # cumulative 429s (metrics surface)
        self.dispatched = 0

    def acquire(self) -> bool:
        """True = seat granted; False = reject with 429."""
        if self.exempt:
            with self._cond:
                self.inflight += 1
                self.dispatched += 1
            return True
        with self._cond:
            if self.inflight < self.seats:
                self.inflight += 1
                self.dispatched += 1
                return True
            if self.waiting >= self.queue_length:
                self.rejected += 1
                return False
            self.waiting += 1
            deadline = self._cond.wait_for(
                lambda: self.inflight < self.seats,
                timeout=self.queue_timeout)
            self.waiting -= 1
            if not deadline:
                self.rejected += 1
                return False
            self.inflight += 1
            self.dispatched += 1
            return True

    def release(self) -> None:
        with self._cond:
            self.inflight -= 1
            # notify_all: a single notify can be consumed by a waiter that is
            # concurrently timing out, stranding the seat while other waiters
            # sleep to rejection
            self._cond.notify_all()

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {"inflight": self.inflight, "waiting": self.waiting,
                    "rejected": self.rejected, "dispatched": self.dispatched}


@dataclass
class FlowSchema:
    """Match rule -> level. Wildcard "*" matches anything; groups match if
    ANY of the user's groups is listed."""

    name: str
    level: str
    users: Tuple[str, ...] = ("*",)
    groups: Tuple[str, ...] = ("*",)
    verbs: Tuple[str, ...] = ("*",)
    resources: Tuple[str, ...] = ("*",)

    def matches(self, user, verb: str, resource: str) -> bool:
        if "*" not in self.verbs and verb not in self.verbs:
            return False
        if "*" not in self.resources and resource not in self.resources:
            return False
        user_ok = "*" in self.users or (user is not None
                                        and user.name in self.users)
        group_ok = "*" in self.groups or (
            user is not None and any(g in self.groups for g in user.groups))
        # users/groups are alternative subject spellings (reference subjects
        # list): either identifies the flow
        if "*" in self.users and "*" in self.groups:
            return True
        return user_ok if "*" in self.groups else (
            group_ok if "*" in self.users else (user_ok or group_ok))


class FlowController:
    """Classify + dispatch. Levels and schemas are fixed at construction
    (the reference watches its config objects; a rebuild here is a new
    controller on the server)."""

    def __init__(self, levels: Sequence[PriorityLevel],
                 schemas: Sequence[FlowSchema]):
        self.levels = {l.name: l for l in levels}
        self.schemas = list(schemas)
        if not self.schemas:
            raise ValueError("at least one FlowSchema (a catch-all) is required")
        for s in self.schemas:
            if s.level not in self.levels:
                raise ValueError(f"schema {s.name!r} names unknown level {s.level!r}")
        last = self.schemas[-1]
        if not ("*" in last.verbs and "*" in last.resources
                and "*" in last.users and "*" in last.groups):
            # the reference guarantees the catch-all FlowSchema exists;
            # without one, unmatched requests would ride a level whose rule
            # they explicitly failed
            raise ValueError(
                f"last schema {last.name!r} must be a universal catch-all")

    def classify(self, user, verb: str, resource: str) -> PriorityLevel:
        for s in self.schemas:
            if s.matches(user, verb, resource):
                return self.levels[s.level]
        return self.levels[self.schemas[-1].level]  # unreachable: catch-all

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {name: lvl.stats() for name, lvl in self.levels.items()}


def default_flow_controller(default_seats: int = 10,
                            queue_length: int = 50,
                            queue_timeout: float = 5.0) -> FlowController:
    """The bootstrap configuration (flowcontrol/bootstrap defaults):
    exempt for cluster admins, a wide `system` level for nodes and control
    plane components, `workload-high` for controllers' writes, and a
    seat-limited `global-default` catch-all."""
    levels = [
        PriorityLevel("exempt", exempt=True),
        PriorityLevel("system", seats=max(default_seats * 3, 30),
                      queue_length=queue_length, queue_timeout=queue_timeout),
        PriorityLevel("global-default", seats=default_seats,
                      queue_length=queue_length, queue_timeout=queue_timeout),
    ]
    schemas = [
        FlowSchema("exempt", "exempt", users=(), groups=("system:masters",)),
        FlowSchema("system-nodes", "system", users=(),
                   groups=("system:nodes",)),
        FlowSchema("system-components", "system", users=(),
                   groups=("system:kube-scheduler",
                           "system:kube-controller-manager")),
        FlowSchema("catch-all", "global-default"),
    ]
    return FlowController(levels, schemas)


# ---- live configuration from API objects --------------------------------------
#
# The PriorityLevelConfiguration/FlowSchema API types live in
# api/flowcontrolapi.py (the serializer cannot import server modules);
# FlowConfigSource below watches them and rebuilds dispatch on change.


class FlowConfigSource:
    """Watch-driven live APF configuration: when PriorityLevelConfiguration/
    FlowSchema objects exist in the store, they replace the bootstrap config;
    when none do, the bootstrap defaults dispatch. Rebuilds preserve nothing
    across swaps (in-flight requests finish on the old levels — their seats
    release into objects no longer consulted, which is also how the
    reference's config changes drain)."""

    KINDS = ("prioritylevelconfigurations", "flowschemas")
    MANDATORY_SCHEMAS = ("exempt", "system-nodes", "system-components")

    def __init__(self, store, bootstrap: FlowController):
        self._store = store
        self._bootstrap = bootstrap
        self._lock = threading.Lock()
        self._current = bootstrap
        self._list_rebuild_rewatch()

    def _list_rebuild_rewatch(self) -> None:
        # ONE consistent snapshot + watch point: two separate lists would
        # lose an object committed between them (store.list_many exists for
        # exactly this race)
        lists, rv = self._store.list_many(self.KINDS)
        self._rebuild(lists[self.KINDS[0]], lists[self.KINDS[1]])
        self._watch = self._store.watch(kind=set(self.KINDS), since_rv=rv)

    def _rebuild(self, levels, schemas) -> None:
        if not levels or not schemas:
            self._current = self._bootstrap
            return
        try:
            built_levels = {l.metadata.name: l.to_level() for l in levels}
            # the MANDATORY bootstrap configuration survives every custom
            # config (the reference always merges it back): without the
            # exempt/system levels a saturated custom level would 429 the
            # control plane — including the DELETE that removes the bad
            # config. User objects override same-named entries.
            for name, lvl in self._bootstrap.levels.items():
                built_levels.setdefault(name, lvl)
            ordered = sorted(schemas, key=lambda s: s.matching_precedence)
            built = [s.to_schema() for s in ordered]
            user_names = {s.name for s in built}
            mandatory = [s for s in self._bootstrap.schemas
                         if s.name in self.MANDATORY_SCHEMAS
                         and s.name not in user_names]
            built = mandatory + built
            last = built[-1]
            if not ("*" in last.verbs and "*" in last.resources
                    and "*" in last.users and "*" in last.groups):
                # the synthesized catch-all must land on a LIMITED level —
                # an arbitrary (possibly Exempt) target would fail open
                target = next(
                    (n for n in ("global-default", *built_levels)
                     if n in built_levels and not built_levels[n].exempt),
                    None)
                if target is None:
                    raise ValueError("no Limited level for the catch-all")
                built.append(FlowSchema("catch-all", target))
            self._current = FlowController(list(built_levels.values()), built)
        except ValueError:
            # inconsistent objects (schema naming a missing level): keep
            # serving the previous configuration rather than failing open
            pass

    def _sync(self) -> None:
        if self._watch.terminated:
            self._list_rebuild_rewatch()
            return
        events = self._watch.drain()
        if events:
            lists, _rv = self._store.list_many(self.KINDS)
            self._rebuild(lists[self.KINDS[0]], lists[self.KINDS[1]])

    def classify(self, user, verb: str, resource: str) -> PriorityLevel:
        with self._lock:
            self._sync()
            return self._current.classify(user, verb, resource)

    def stats(self):
        with self._lock:
            self._sync()
            return self._current.stats()

"""Deterministic fault-injection harness for the failure-domain tests.

The counterpart of `kubernetes_tpu/chaos/faultinject.py`, whole: the
registry of named injection sites and the programmable per-site plans the
chaos tests drive:

  fail-next-N     the next N fires at the site raise FaultInjected
  fail-rate       each fire raises with probability `rate` (seeded RNG, so a
                  chaos run is exactly reproducible)
  delay           each fire sleeps `delay_s` before proceeding
  kill            ONE fire raises FaultKill — a BaseException, so it escapes
                  `except Exception` supervisors by design (a hard thread
                  death, not a handled fault)

Hot-path contract: every instrumented site guards with the single falsy
module-level check

    if faultinject.ACTIVE is not None:
        faultinject.ACTIVE.fire("site.name")

so a disabled injector costs one module-attribute load per batch, cycle or
wave (never per pod) and nothing else; disabled_check_cost_ns() measures
that guard.

Two firing forms, split by lock discipline:

  fire(site, key=None)        may raise FaultInjected/FaultKill or SLEEP
                              (delay plans) — only legal at sites that hold
                              no store or scheduler lock.
  should_drop(site, key=None) returns True when the fire should be dropped;
                              NEVER blocks — the only form legal under a lock.

The registry keeps every site name of the JAX package, so a plan written
for it validates here too. The port wires all but one of them:
`solver.solve` (scheduler/batch.py BatchScheduler._solve_device),
`rebalance.cycle` (scheduler/rebalance.py), `store.bind_many` (store/store.py
APIStore.bind_many's entry, no lock held), `watch.deliver` (store/store.py
Watch._deliver and _deliver_coalesced, drop-only: the store lock is held),
`bind.worker` and `native.commit`, `partition.dispatch`
(scheduler/partition.py) and `process.worker` (scheduler/mpsched.py). The
other, `kubelet.heartbeat`, names a layer the port has not ported yet; the
registry says which ROADMAP.md item brings it, and a plan armed for it
validates and never fires.

Arming: programmatic `arm([FaultPlan(...), ...])` (tests), or the
FAULT_INJECT env var at import time, e.g.

  FAULT_INJECT="solver.solve=fail:count=3;rebalance.cycle=rate:rate=0.1,seed=7"

`key` scopes a fire to one object (a wave, a node name, a pod key); plans
with a `match` only act on fires whose key contains that substring.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from ..obs import tracebuf as _tracebuf

# The injection-site registry: site name -> where it is wired. Unknown sites
# in a plan are a hard arm() error — a typo'd site would otherwise silently
# inject nothing and the chaos test would pass vacuously.
SITES: Dict[str, str] = {
    "store.bind_many": "store/store.py APIStore.bind_many entry (no lock held)",
    "solver.solve": "scheduler/batch.py BatchScheduler._solve_device",
    "watch.deliver": "store/store.py Watch._deliver and _deliver_coalesced "
                     "(drop-only: store lock)",
    # the bind worker: once per drain cycle, before the merged chunk's
    # bind_many (a fail plan is an escaped exception the supervisor counts
    # and retries once; a kill plan is the worker's hard death)
    "bind.worker": "scheduler/batch.py BatchScheduler._bind_cycle (bind worker, "
                   "no lock held)",
    "kubelet.heartbeat": "agent/hollow.py HollowKubelet.heartbeat (drop-only); "
                         "not wired until the agent, ROADMAP.md item 7",
    # the native commit boundary: bind_many/delete_pods between the
    # validate/clone phase and the commit phase (no lock held)
    "native.commit": "store/store.py bind_many/delete_pods native phase gap "
                     "(no lock held; fires when the native commit engine is "
                     "selected)",
    # the partitioned dispatch layer: once per pipeline drive cycle, key =
    # "partition-<i>" (so `match=` scopes a plan to one partition). fail and
    # rate plans are absorbed dispatch hiccups (the cycle retries, the
    # coordinator counts dispatch_faults); a kill plan is that partition's
    # HARD death, absorbed by the survivors (remap + resync)
    "partition.dispatch": "scheduler/partition.py "
                          "PartitionedScheduler._drive_pipeline (no lock)",
    # the background rebalancer: fires in scheduler/rebalance.py
    # Rebalancer.cycle at cycle start (key="cycle"), at every migration-wave
    # boundary (key="wave-<i>"), and MID-WAVE between replacement
    # create_many and victim delete_pods (key="midwave") — the
    # conservation-critical gap: an injected fault there rolls the wave's
    # replacements back, a kill plan leaves a transient duplicate but never
    # a lost or double-bound pod. No lock held at any fire.
    "rebalance.cycle": "scheduler/rebalance.py Rebalancer.cycle / wave "
                       "boundaries + midwave gap (no lock held)",
    # the multi-process scheduler: once per worker per round in the owner
    # process, before that worker's round is dispatched, key = "worker-<i>".
    # fail and rate plans skip that worker's round (its pods re-offer next
    # round, counted in dispatch_faults); a kill plan SIGKILLs the REAL
    # worker process, which the supervisor detects, respawns and reconciles
    "process.worker": "scheduler/mpsched.py MPScheduler._round "
                      "(owner side, no lock held; kill = SIGKILL the worker "
                      "process)",
}

# sites that fire under a lock (or inside a loop that must not stall): only
# should_drop() consults them, so delay plans there are an arm()-time error
DROP_ONLY_SITES = frozenset({"watch.deliver", "kubelet.heartbeat"})

MODES = ("fail", "rate", "delay", "kill")


class FaultInjected(RuntimeError):
    """An injected (handled) fault: the site's failure-domain machinery is
    expected to catch, retry, or requeue."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at {site}")
        self.site = site


class FaultKill(BaseException):
    """An injected HARD death (bind.worker kill plans): deliberately a
    BaseException so supervisor `except Exception` blocks do not absorb it —
    the thread dies and the liveness check must recover."""

    def __init__(self, site: str):
        super().__init__(f"injected kill at {site}")
        self.site = site


@dataclass
class FaultPlan:
    """One site's programmed behavior. Counting starts after `after` fires
    (a mid-run kill is `FaultPlan("bind.worker", "kill", after=2)`); `count`
    bounds fail/delay plans (None = unbounded); `match` scopes to fires
    whose key contains the substring."""

    site: str
    mode: str  # fail | rate | delay | kill
    count: Optional[int] = 1
    rate: float = 0.0
    seed: int = 0
    delay_s: float = 0.0
    after: int = 0
    match: Optional[str] = None
    message: str = ""
    # runtime state (owned by the Injector, under its lock)
    _fired: int = field(default=0, repr=False)
    _injected: int = field(default=0, repr=False)
    _rng: Optional[random.Random] = field(default=None, repr=False)

    def validate(self) -> None:
        if self.site not in SITES:
            raise ValueError(
                f"unknown injection site {self.site!r}; known: "
                f"{sorted(SITES)}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"known: {MODES}")
        if self.mode == "delay" and self.site in DROP_ONLY_SITES:
            raise ValueError(
                f"site {self.site} fires under a lock (should_drop form): "
                "delay plans are forbidden there — schedlint LK002")
        if self.mode == "kill" and self.site in DROP_ONLY_SITES:
            raise ValueError(
                f"site {self.site} is drop-only; kill plans need a raising "
                "site (bind.worker)")

    def _decide(self, key: Optional[str]) -> Optional[str]:
        """Returns the action ('fail'/'delay'/'kill') for this fire, or None.
        Caller holds the injector lock."""
        if self.match is not None and (key is None or self.match not in key):
            return None
        self._fired += 1
        if self._fired <= self.after:
            return None
        if self.mode == "rate":
            if self._rng is None:
                self._rng = random.Random(self.seed)
            if self._rng.random() < self.rate:
                self._injected += 1
                return "fail"
            return None
        past_after = self._fired - self.after
        if self.count is not None and self._injected >= self.count:
            return None
        if self.mode == "kill" and past_after >= 1:
            self._injected += 1
            return "kill"
        if self.mode in ("fail", "delay"):
            self._injected += 1
            return self.mode
        return None


class Injector:
    """The armed plan set. Thread-safe: fires arrive from the scheduling
    thread, the bind worker, kubelet loops, and the store's emit path."""

    def __init__(self, plans: Iterable[FaultPlan]):
        self._lock = threading.Lock()
        self._plans: Dict[str, List[FaultPlan]] = {}
        for p in plans:
            p.validate()
            self._plans.setdefault(p.site, []).append(p)

    def fire(self, site: str, key: Optional[str] = None) -> None:
        """The raising/sleeping form — ONLY for sites that hold no lock.
        Raises FaultInjected (handled-fault contract) or FaultKill (hard
        death), or sleeps for a delay plan, or returns untouched."""
        delay = 0.0
        action = None
        plan = None
        with self._lock:
            for p in self._plans.get(site, ()):
                act = p._decide(key)
                if act is not None:
                    action, plan = act, p
                    if act == "delay":
                        delay = p.delay_s
                    break
        # trace timeline: an INJECTED action lands as an instant on the
        # chaos track (per fire decision, outside the injector lock)
        if action is not None and _tracebuf.ACTIVE is not None:
            _tracebuf.ACTIVE.instant(
                "chaos", "fault:%s" % site, cat="chaos",
                args={"action": action, "key": key or ""})
        if action == "delay" and delay > 0:
            time.sleep(delay)  # outside the injector lock
        elif action == "kill":
            raise FaultKill(site)
        elif action == "fail":
            raise FaultInjected(site, plan.message)

    def should_drop(self, site: str, key: Optional[str] = None) -> bool:
        """The non-blocking form for lock-held sites: True when the armed
        plan says this fire is dropped. Never raises, never sleeps."""
        hit = False
        with self._lock:
            for p in self._plans.get(site, ()):
                if p._decide(key) in ("fail", "kill"):
                    hit = True
                    break
        if hit and _tracebuf.ACTIVE is not None:
            # outside the injector lock; the trace ring is a leaf lock, so
            # a lock-held caller site takes no lock after it
            _tracebuf.ACTIVE.instant(
                "chaos", "fault:%s" % site, cat="chaos",
                args={"action": "drop", "key": key or ""})
        return hit

    def stats(self) -> Dict[str, Dict[str, int]]:
        """{site: {fired, injected}} — what the chaos rung reports."""
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for site, plans in self._plans.items():
                out[site] = {
                    "fired": sum(p._fired for p in plans),
                    "injected": sum(p._injected for p in plans),
                }
        return out


# THE hot-path flag: None when disabled. Every instrumented site guards with
# `if faultinject.ACTIVE is not None:` — one attribute load, no call.
ACTIVE: Optional[Injector] = None


def arm(plans: Iterable[FaultPlan]) -> Injector:
    """Install an injector (replacing any armed one) and return it."""
    global ACTIVE
    ACTIVE = Injector(plans)
    return ACTIVE


def disarm() -> None:
    global ACTIVE
    ACTIVE = None


def enabled() -> bool:
    return ACTIVE is not None


def disabled_check_cost_ns(n: int = 50_000, passes: int = 5) -> float:
    """Measured per-check cost of the disabled-injector guard (the exact
    expression hot paths use), in nanoseconds: an overhead budget is then
    asserted from a measurement instead of by differencing two noisy runs.
    Best-of-`passes`: the minimum filters co-scheduling spikes on a busy
    host."""
    best = float("inf")
    hits = 0
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(n):
            if ACTIVE is not None:  # the hot-path guard, verbatim
                hits += 1
        best = min(best, time.perf_counter() - t0)
    assert hits == 0 or ACTIVE is not None
    return best / n * 1e9


def parse_env(spec: str) -> List[FaultPlan]:
    """FAULT_INJECT grammar: `site=mode[:k=v[,k=v...]];site2=...`.
    Example: solver.solve=fail:count=3;store.bind_many=rate:rate=0.1,seed=7
    """
    plans: List[FaultPlan] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        site, _, rest = part.partition("=")
        mode, _, argstr = rest.partition(":")
        kwargs: Dict[str, object] = {}
        for kv in argstr.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            if k in ("count", "seed", "after"):
                kwargs[k] = int(v)
            elif k in ("rate", "delay_s"):
                kwargs[k] = float(v)
            elif k in ("match", "message"):
                kwargs[k] = v
            else:
                raise ValueError(f"unknown FAULT_INJECT arg {k!r} in {part!r}")
        if "count" not in kwargs and mode.strip() in ("fail", "kill"):
            kwargs["count"] = 1
        plan = FaultPlan(site=site.strip(), mode=mode.strip(), **kwargs)
        plan.validate()
        plans.append(plan)
    return plans


_env_spec = os.environ.get("FAULT_INJECT", "")
if _env_spec:
    ACTIVE = Injector(parse_env(_env_spec))

"""In-memory API store: versioned objects, watches, atomic binds.

The lean counterpart of `kubernetes_tpu/store/store.py` that the batch
scheduler needs: create / create_many / get / update / guaranteed_update /
delete / delete_pods / list / list_many / bind / bind_many /
update_pod_status / watch, one monotonic resource version (RV) across
kinds, bounded history for watch resume, and coalesced delivery of batched
writes to watchers that opt in. Kinds are `nodes`, `pods`, `namespaces`,
`podgroups`, `poddisruptionbudgets`, `events`, the storage kinds the volume
plugins read and write (`persistentvolumes`, `persistentvolumeclaims`,
`storageclasses`, `csinodes`) and the DRA kinds DynamicResources reads and
writes (`resourceclaims`, `resourceslices`, `deviceclasses`); any other kind
raises.

Columnar pod rows, shared-memory export, the lock-order graph, the native
commit engine and chaos sites of the JAX package's store are not part of
this slice (ROADMAP.md, queue 1 item 7: the remaining host layers).
"""

from __future__ import annotations

import copy
import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

KINDS = ("nodes", "pods", "namespaces", "podgroups", "poddisruptionbudgets", "events",
         "persistentvolumes", "persistentvolumeclaims", "storageclasses", "csinodes",
         "resourceclaims", "resourceslices", "deviceclasses")


class ConflictError(Exception):
    pass


class ResourceVersionTooOldError(Exception):
    """Watch requested from an RV older than retained history (410 Gone)."""


class NotFoundError(Exception):
    pass


class AlreadyExistsError(Exception):
    pass


class AlreadyBoundError(Exception):
    pass


@dataclass(frozen=True)
class Event:
    type: str
    kind: str
    obj: Any
    resource_version: int
    prev: Any = None


@dataclass(frozen=True)
class CoalescedEvent:
    """One delivery for a whole batched write (create_many / bind_many), sent
    only to watchers that subscribed with coalesce=True; `origin` is the
    writer's tag (a scheduler recognizes its own binds by it)."""

    type: str
    kind: str
    events: Tuple[Event, ...]
    resource_version: int
    origin: Optional[str] = None


def _shallow(obj):
    new = object.__new__(obj.__class__)
    new.__dict__ = obj.__dict__.copy()
    return new


def pod_structural_clone(pod):
    """Fresh Pod/ObjectMeta/PodSpec/PodStatus with private label, annotation
    and condition containers; containers, tolerations, affinity and the other
    spec members stay shared and are read-only by contract."""
    meta = _shallow(pod.metadata)
    meta.labels = dict(meta.labels)
    meta.annotations = dict(meta.annotations)
    spec = _shallow(pod.spec)
    status = _shallow(pod.status)
    status.conditions = list(status.conditions)
    new = _shallow(pod)
    new.metadata = meta
    new.spec = spec
    new.status = status
    return new


def pod_bind_clone(pod):
    """Minimal clone for a bind: fresh Pod/ObjectMeta/PodSpec shells (a bind
    writes only spec.node_name and metadata.resource_version)."""
    new = _shallow(pod)
    new.metadata = _shallow(pod.metadata)
    new.spec = _shallow(pod.spec)
    return new


def _event_copy(obj):
    """Events carry a private copy: pods a structural clone, others a deep
    copy."""
    if getattr(obj, "kind", "") == "Pod":
        return pod_structural_clone(obj)
    return copy.deepcopy(obj)


class Watch:
    """One watch subscription with a bounded buffer. A consumer that falls
    `maxsize` deliveries behind is terminated (`terminated` turns True) and
    must relist, as the reference's cacher does to slow watchers."""

    DEFAULT_MAXSIZE = 10_000

    def __init__(self, store: "APIStore", kind=None, maxsize: int = DEFAULT_MAXSIZE,
                 coalesce: bool = False):
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize or 0)
        self._store = store
        self._kinds = (None if kind is None
                       else {kind} if isinstance(kind, str) else set(kind))
        self.coalesce = coalesce
        self._stopped = False
        self.terminated = False

    def _deliver(self, item) -> None:
        if self.terminated or self._stopped:
            return
        if self._kinds is not None and item.kind not in self._kinds:
            return
        try:
            self._q.put_nowait(item)
        except queue.Full:
            self.terminated = True
            self._store._unsubscribe(self)

    def drain(self, max_n: Optional[int] = None) -> List:
        """Take up to max_n buffered deliveries; the rest stay buffered."""
        out = []
        while max_n is None or len(out) < max_n:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        return out

    def stop(self) -> None:
        self._stopped = True
        self._store._unsubscribe(self)


class APIStore:
    """The hub every component is a client of."""

    HISTORY_LIMIT = 50_000  # events kept for watch resume (the reference's default)

    def __init__(self):
        self._lock = threading.RLock()
        self._rv = 0
        self._objects: Dict[str, Dict[str, Any]] = {k: {} for k in KINDS}
        self._watchers: List[Watch] = []
        self._history: deque = deque(maxlen=self.HISTORY_LIMIT)

    # -- helpers ---------------------------------------------------------------

    @staticmethod
    def object_key(obj) -> str:
        meta = obj.metadata
        return f"{meta.namespace}/{meta.name}" if meta.namespace else meta.name

    def _kind(self, kind: str) -> Dict[str, Any]:
        objs = self._objects.get(kind)
        if objs is None:
            raise ValueError(
                f"kind {kind!r} is not stored by this slice of the port "
                "(ROADMAP.md queue 1 item 7: the remaining host layers)")
        return objs

    def _history_floor(self) -> int:
        """Oldest RV a watch can resume from with a complete replay."""
        if len(self._history) < self._history.maxlen:
            return 0
        return self._history[0].resource_version - 1

    def _emit(self, ev: Event) -> None:
        self._history.append(ev)
        for w in list(self._watchers):
            w._deliver(ev)

    def _emit_batch(self, etype: str, kind: str, events: List[Event],
                    origin: Optional[str]) -> None:
        if not events:
            return
        self._history.extend(events)
        cev = CoalescedEvent(etype, kind, tuple(events),
                             events[-1].resource_version, origin)
        for w in list(self._watchers):
            if w.coalesce:
                w._deliver(cev)
            else:
                for ev in events:
                    w._deliver(ev)

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    # -- CRUD ------------------------------------------------------------------

    def create(self, kind: str, obj) -> Any:
        with self._lock:
            objs = self._kind(kind)
            key = self.object_key(obj)
            if key in objs:
                raise AlreadyExistsError(f"{kind} {key} already exists")
            obj = copy.deepcopy(obj)
            obj.metadata.resource_version = self._next_rv()
            objs[key] = obj
            self._emit(Event(ADDED, kind, _event_copy(obj), self._rv))
            return copy.deepcopy(obj)

    def create_many(self, kind: str, objects: Iterable[Any], origin: Optional[str] = None,
                    consume: bool = False) -> Tuple[int, List[Tuple[str, str]]]:
        """Bulk create with ONE coalesced ADDED delivery; per-object failures
        (AlreadyExists) do not abort the batch. consume=True hands the
        objects to the store (the caller never touches them again), which
        skips the isolation copy. Returns (created, errors)."""
        errors: List[Tuple[str, str]] = []
        events: List[Event] = []
        with self._lock:
            objs = self._kind(kind)
            for obj in objects:
                key = self.object_key(obj)
                if key in objs:
                    errors.append((key, f"{kind} {key} already exists"))
                    continue
                if not consume:
                    obj = copy.deepcopy(obj)
                obj.metadata.resource_version = self._next_rv()
                objs[key] = obj
                events.append(Event(ADDED, kind, _event_copy(obj), self._rv))
            self._emit_batch(ADDED, kind, events, origin)
        return len(events), errors

    def get(self, kind: str, key: str) -> Any:
        with self._lock:
            try:
                return copy.deepcopy(self._kind(kind)[key])
            except KeyError:
                raise NotFoundError(f"{kind} {key} not found") from None

    def update(self, kind: str, obj, check_rv: bool = True) -> Any:
        """Replace an object; with check_rv its resource version must be the
        stored one (check_rv=False is an unconditional write)."""
        with self._lock:
            objs = self._kind(kind)
            key = self.object_key(obj)
            old = objs.get(key)
            if old is None:
                raise NotFoundError(f"{kind} {key} not found")
            if check_rv and old.metadata.resource_version != obj.metadata.resource_version:
                raise ConflictError(f"{kind} {key}: rv {obj.metadata.resource_version} "
                                    f"!= {old.metadata.resource_version}")
            obj = copy.deepcopy(obj)
            obj.metadata.resource_version = self._next_rv()
            objs[key] = obj
            self._emit(Event(MODIFIED, kind, _event_copy(obj), self._rv, old))
            return copy.deepcopy(obj)

    def guaranteed_update(self, kind: str, key: str, mutate, max_retries: int = 16) -> Any:
        """Read-modify-write with conflict retry (etcd3 GuaranteedUpdate)."""
        for _ in range(max_retries):
            updated = mutate(self.get(kind, key))
            try:
                return self.update(kind, updated)
            except ConflictError:
                continue
        raise ConflictError(f"{kind} {key}: too many conflicts")

    def delete(self, kind: str, key: str) -> Any:
        with self._lock:
            objs = self._kind(kind)
            old = objs.pop(key, None)
            if old is None:
                raise NotFoundError(f"{kind} {key} not found")
            obj = _event_copy(old)
            obj.metadata.resource_version = self._next_rv()
            self._emit(Event(DELETED, kind, obj, self._rv, old))
            return copy.deepcopy(obj)

    def list(self, kind: str, predicate=None) -> Tuple[List[Any], int]:
        """Consistent snapshot (copies of the objects `predicate` accepts, all
        without one) + the RV it is current to."""
        with self._lock:
            items = self._kind(kind).values()
            if predicate is not None:
                items = [o for o in items if predicate(o)]
            return [copy.deepcopy(o) for o in items], self._rv

    def list_many(self, kinds: Iterable[str]) -> Tuple[Dict[str, List[Any]], int]:
        """Several kinds under one RV: the safe way to seed an informer."""
        with self._lock:
            return ({k: [copy.deepcopy(o) for o in self._kind(k).values()]
                     for k in kinds}, self._rv)

    def history_events(self) -> List[Event]:
        """The retained event history, oldest first."""
        with self._lock:
            return list(self._history)

    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    # -- pods ------------------------------------------------------------------

    def bind(self, namespace: str, name: str, node_name: str) -> Any:
        """Atomic pod->node binding (BindingREST.Create): fails if the pod is
        already bound."""
        bound, errors = self.bind_many([(namespace, name, node_name)])
        if errors:
            key, msg = errors[0]
            if " is already bound to " in msg:
                raise AlreadyBoundError(msg)
            raise NotFoundError(msg)
        with self._lock:
            return pod_structural_clone(self._objects["pods"][f"{namespace}/{name}"])

    def bind_many(self, bindings: Iterable[Tuple[str, str, str]],
                  origin: Optional[str] = None) -> Tuple[int, List[Tuple[str, str]]]:
        """Batched bind under one lock; each binding is its own transaction.
        bindings = (namespace, name, node) triples. Returns (bound, errors);
        watchers with coalesce=True get one delivery tagged `origin`."""
        errors: List[Tuple[str, str]] = []
        events: List[Event] = []
        with self._lock:
            pods = self._objects["pods"]
            for namespace, name, node_name in bindings:
                key = f"{namespace}/{name}"
                pod = pods.get(key)
                if pod is None:
                    errors.append((key, f"pods {key} not found"))
                    continue
                if pod.spec.node_name:
                    errors.append((key, f"pod {key} is already bound to {pod.spec.node_name}"))
                    continue
                new = pod_bind_clone(pod)
                new.spec.node_name = node_name
                new.metadata.resource_version = self._next_rv()
                pods[key] = new
                events.append(Event(MODIFIED, "pods", pod_bind_clone(new), self._rv, pod))
            self._emit_batch(MODIFIED, "pods", events, origin)
        return len(events), errors

    def delete_pods(self, keys: Iterable[str],
                    origin: Optional[str] = None) -> Tuple[int, List[Tuple[str, str]]]:
        """Batched pod delete: one critical section and one coalesced DELETED
        delivery for a whole victim set. Each deleted pod's event carries a
        structural clone at its post-delete RV with prev=old; per-key misses
        (and duplicate keys) come back as errors without aborting the batch.
        Returns (deleted, errors)."""
        errors: List[Tuple[str, str]] = []
        events: List[Event] = []
        with self._lock:
            pods = self._objects["pods"]
            for key in keys:
                old = pods.pop(key, None)
                if old is None:
                    errors.append((key, f"pods {key} not found"))
                    continue
                obj = pod_structural_clone(old)
                obj.metadata.resource_version = self._next_rv()
                events.append(Event(DELETED, "pods", obj, self._rv, old))
            self._emit_batch(DELETED, "pods", events, origin)
        return len(events), errors

    def update_pod_status(self, namespace: str, name: str, mutate_status) -> Any:
        """Status-subresource write: mutate_status(status) on a private clone."""
        with self._lock:
            key = f"{namespace}/{name}"
            old = self._objects["pods"].get(key)
            if old is None:
                raise NotFoundError(f"pods {key} not found")
            pod = pod_structural_clone(old)
            mutate_status(pod.status)
            pod.metadata.resource_version = self._next_rv()
            self._objects["pods"][key] = pod
            self._emit(Event(MODIFIED, "pods", pod_structural_clone(pod), self._rv, old))
            return pod_structural_clone(pod)

    # -- watch -----------------------------------------------------------------

    def watch(self, kind=None, since_rv: int = -1, maxsize: int = Watch.DEFAULT_MAXSIZE,
              coalesce: bool = False) -> Watch:
        """Subscribe. since_rv >= 0 first replays history events with
        rv > since_rv, per object; raises ResourceVersionTooOldError when the
        history no longer reaches back that far."""
        with self._lock:
            if 0 <= since_rv < self._history_floor():
                raise ResourceVersionTooOldError(
                    f"rv {since_rv} is older than retained history; relist required")
            w = Watch(self, kind, maxsize=maxsize, coalesce=coalesce)
            if since_rv >= 0:
                for ev in self._history:
                    if ev.resource_version > since_rv:
                        w._deliver(ev)
            self._watchers.append(w)
            return w

    def _unsubscribe(self, w: Watch) -> None:
        with self._lock:
            if w in self._watchers:
                self._watchers.remove(w)

"""core/v1 Event, the EventRecorder and the PodLog channel.

The counterpart of `kubernetes_tpu/api/events.py` (Event, EventRecorder,
events_for, PodLog, append_pod_log; reference:
staging/src/k8s.io/api/core/v1/types.go Event, client-go tools/record). Components narrate what they did to an object
("FailedScheduling", "GangPreempting", "Preempted"), and repeated identical
events fold into one object with a bumped `count` instead of flooding the
store. PodLog and append_pod_log are the node agents' log channel through
the store.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping

from ..utils import Clock
from .types import ObjectMeta, new_uid

NORMAL = "Normal"
WARNING = "Warning"


@dataclass
class Event:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_kind: str = ""
    involved_name: str = ""
    involved_namespace: str = ""
    reason: str = ""
    message: str = ""
    type: str = NORMAL  # Normal | Warning
    count: int = 1
    source: str = ""  # reporting component
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0

    kind = "Event"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "Event":
        inv = d.get("involvedObject") or {}
        return Event(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            involved_kind=inv.get("kind", ""),
            involved_name=inv.get("name", ""),
            involved_namespace=inv.get("namespace", ""),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
            type=d.get("type", NORMAL),
            count=int(d.get("count", 1) or 1),
            source=(d.get("source") or {}).get("component", "")
            if isinstance(d.get("source"), Mapping) else d.get("source", ""),
            first_timestamp=float(d.get("firstTimestamp", 0.0) or 0.0),
            last_timestamp=float(d.get("lastTimestamp", 0.0) or 0.0),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.kind, "apiVersion": "v1",
            "metadata": self.metadata.to_dict(),
            "involvedObject": {"kind": self.involved_kind,
                               "name": self.involved_name,
                               "namespace": self.involved_namespace},
            "reason": self.reason,
            "message": self.message,
            "type": self.type,
            "count": self.count,
            **({"source": {"component": self.source}} if self.source else {}),
            **({"firstTimestamp": self.first_timestamp}
               if self.first_timestamp else {}),
            **({"lastTimestamp": self.last_timestamp}
               if self.last_timestamp else {}),
        }


class EventRecorder:
    """record(obj, type, reason, message), best effort.

    Identical (involved, reason, message) events fold into one Event with
    count += 1 (the EventAggregator behaviour): a failing pod retrying every
    second must not mint thousands of objects. Write failures are swallowed:
    events are narration and never break the component emitting them."""

    def __init__(self, store, component: str = "", clock=None):
        self.store = store
        self.component = component
        self.clock = clock or Clock()
        self._lock = threading.Lock()
        self._known: Dict[str, str] = {}  # aggregation key -> event object name

    def _agg_key(self, kind: str, namespace: str, name: str,
                 reason: str, message: str) -> str:
        return hashlib.sha1(
            f"{kind}|{namespace}|{name}|{reason}|{message}|{self.component}"
            .encode()).hexdigest()[:16]

    def event(self, obj, etype: str, reason: str, message: str) -> None:
        kind = getattr(obj, "kind", type(obj).__name__)
        namespace = getattr(obj.metadata, "namespace", "") or "default"
        name = obj.metadata.name
        now = self.clock.now()
        agg = self._agg_key(kind, namespace, name, reason, message)
        ev_name = f"{name}.{agg}"
        key = f"{namespace}/{ev_name}"

        def bump(cur: Event) -> Event:
            cur.count += 1
            cur.last_timestamp = now
            return cur

        try:
            with self._lock:
                # create first for unseen keys (one store op); _known remembers
                # the aggregation keys already created, whose repeats bump
                if agg in self._known:
                    try:
                        self.store.guaranteed_update("events", key, bump)
                        return
                    except Exception:
                        self._known.pop(agg, None)  # deleted meanwhile: recreate
                _created, errs = self.store.create_many(
                    "events", [Event(
                        metadata=ObjectMeta(name=ev_name, namespace=namespace, uid=new_uid()),
                        involved_kind=kind, involved_name=name,
                        involved_namespace=namespace, reason=reason, message=message,
                        type=etype, source=self.component,
                        first_timestamp=now, last_timestamp=now)],
                    consume=True)
                if errs:
                    # already exists (forgotten by _known): bump the count
                    self.store.guaranteed_update("events", key, bump)
                self._known[agg] = ev_name
                if len(self._known) > 10_000:
                    self._known.clear()  # bounded memory; worst case re-create
        except Exception:
            pass  # best effort


def events_for(store, kind: str, namespace: str, name: str):
    """All events about one object, oldest first."""
    evs, _ = store.list(
        "events",
        lambda e: (e.involved_kind == kind and e.involved_name == name
                   and e.involved_namespace == namespace))
    return sorted(evs, key=lambda e: e.last_timestamp)


# ---- pod logs -----------------------------------------------------------------


@dataclass
class PodLog:
    """The kubelet->apiserver log channel for one pod.

    The reference serves `kubectl logs` by proxying the apiserver to the
    kubelet, which reads per-container log files written by the CRI runtime
    (pkg/kubelet/kuberuntime/kuberuntime_logs.go; registry/core/pod/rest/
    log.go). This build's transport is the store: node agents append lines
    here (in-process kubelets directly, HTTP-joined nodes via PATCH) and the
    server renders GET /api/v1/namespaces/{ns}/pods/{name}/log from it.
    Named after the pod; bounded to MAX_LINES (oldest dropped), the log-file
    rotation analog."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    entries: list = field(default_factory=list)  # "ts container msg" strings

    kind = "PodLog"
    MAX_LINES = 1000

    @staticmethod
    def from_dict(d: Mapping) -> "PodLog":
        return PodLog(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            entries=list(d.get("entries") or []),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"apiVersion": "v1", "kind": "PodLog",
                "metadata": self.metadata.to_dict(),
                "entries": list(self.entries)}


def append_pod_log(store, namespace: str, name: str, container: str,
                   message: str, now: float, pod_uid: str = "") -> None:
    """Best-effort append of one log line (store transport; see PodLog).
    With pod_uid, the created channel carries an ownerReference to its pod so
    the garbage collector reaps it after pod deletion."""
    from ..store import NotFoundError

    line = f"{now:.3f} [{container}] {message}"
    key = f"{namespace}/{name}"
    try:
        def bump(obj):
            refs = obj.metadata.owner_references
            if pod_uid and refs and refs[0].get("uid") not in ("", pod_uid):
                # same-name pod was recreated: this is a NEW log stream (the
                # log-file-per-pod-UID analog) — reset content and re-own, or
                # the GC would reap the live pod's lines as an orphan
                obj.metadata.owner_references = [
                    {"kind": "Pod", "name": name, "uid": pod_uid}]
                obj.entries = [line]
                return obj
            obj.entries.append(line)
            if len(obj.entries) > PodLog.MAX_LINES:
                del obj.entries[:len(obj.entries) - PodLog.MAX_LINES]
            return obj

        store.guaranteed_update("podlogs", key, bump)
    except NotFoundError:
        meta = ObjectMeta(name=name, namespace=namespace)
        if pod_uid:
            meta.owner_references = [{"kind": "Pod", "name": name,
                                      "uid": pod_uid}]
        try:
            store.create("podlogs", PodLog(metadata=meta, entries=[line]))
        except Exception:
            pass  # lost race with another writer: next append lands
    except Exception:
        pass  # logging must never break pod lifecycle

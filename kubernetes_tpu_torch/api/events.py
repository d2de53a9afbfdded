"""core/v1 Event and the EventRecorder.

The counterpart of `kubernetes_tpu/api/events.py` (Event, EventRecorder,
events_for; reference: staging/src/k8s.io/api/core/v1/types.go Event,
client-go tools/record). Components narrate what they did to an object
("FailedScheduling", "GangPreempting", "Preempted"), and repeated identical
events fold into one object with a bumped `count` instead of flooding the
store. Pod logs come with the node agent, ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from typing import Dict

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

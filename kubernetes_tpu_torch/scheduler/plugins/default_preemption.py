"""DefaultPreemption: the victim-execution half.

The counterpart of `kubernetes_tpu/scheduler/plugins/default_preemption.py`
:228-307 (reference: pkg/scheduler/framework/preemption/preemption.go
prepareCandidate :431, prepareCandidateAsync :470), the part the gang
victim cover executes through (scheduler/gangpreempt.py): narrate each
victim with a "Preempted" event, delete the victims in one batched
store.delete_pods, and, with async_preparation (the SchedulerAsyncPreemption
default), do both on one preparation worker thread off the scheduling
thread.

The per-pod PostFilter (candidate dry runs, PDB-aware reprieve, candidate
selection, nomination) comes with the serial framework and plugins,
ROADMAP.md queue 1 item 2; post_filter raises until then.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Optional

from ..serial import NOT_PORTED


class DefaultPreemption:
    name = "DefaultPreemption"

    def __init__(self, store=None, recorder=None, async_preparation: bool = True):
        self.store = store
        self._recorder = recorder
        # SchedulerAsyncPreemption: victim deletion off the scheduling thread
        # (beta, on by default in the reference)
        self.async_preparation = async_preparation
        # one shared deletion worker, created at first use
        self._prep_q: Optional[_queue.Queue] = None
        self._prep_thread: Optional[threading.Thread] = None

    def post_filter(self, state, pod, filtered_statuses):
        raise NotImplementedError(
            "per-pod preemption (DefaultPreemption.post_filter) is " + NOT_PORTED.format(2))

    def _narrate_victims(self, victims, preemptor_name: str, node_name: str) -> None:
        """One "Preempted" event per victim, through the scheduler's recorder
        (shared clock and aggregation)."""
        try:
            if self._recorder is None:
                from ...api.events import EventRecorder

                self._recorder = EventRecorder(self.store, component="default-scheduler")
            for v in victims:
                self._recorder.event(v, "Normal", "Preempted",
                                     f"Preempted by pod {preemptor_name} on node {node_name}")
        except Exception:
            pass

    def _delete_victims(self, victims) -> None:
        """One store critical section and one coalesced DELETED delivery for
        the whole victim set; a victim already gone is a per-key miss."""
        self.store.delete_pods([v.key for v in victims])

    def _ensure_prep_worker(self) -> None:
        if self._prep_q is None:
            self._prep_q = _queue.Queue()
        if self._prep_thread is None or not self._prep_thread.is_alive():
            self._prep_thread = threading.Thread(target=self._prep_loop, daemon=True)
            self._prep_thread.start()

    def _prep_loop(self) -> None:
        while True:
            victims, preemptor_name, node_name = self._prep_q.get()
            try:
                self._narrate_victims(victims, preemptor_name, node_name)
                self._delete_victims(victims)
            finally:
                self._prep_q.task_done()

    def wait_for_preparation(self, timeout: float = 5.0) -> None:
        """Wait (bounded) for outstanding async victim deletions."""
        if self._prep_q is None:
            return
        deadline = time.monotonic() + timeout
        while self._prep_q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.005)

"""Leader-elected control plane bundle: scheduler + controller manager.

reference: cmd/kube-scheduler/app/server.go:167 (Run wires healthz, then
LeaderElector.Run at :281 — only the leader runs sched.Run) and
cmd/kube-controller-manager/app/controllermanager.go (one elected manager
starting every controller loop). This is the component _cluster_daemon.py and
HA deployments embed: N replicas each construct a ControlPlane; exactly one
drives the cluster at a time, a standby takes over within lease_duration.

The port's scheduler runs on a device: `device` (the card, "cuda", unless
the caller asks for the CPU) passes to the BatchScheduler this replica
builds when it leads (the serial Scheduler runs on the host), and the
constructor resolves it first, so a replica built for the card raises where
there is none. A standby builds a
fresh scheduler on the same device when it takes the lease: its first batch
uploads the device mirrors whole, later incremental batches scatter the
dirty rows.

The counterpart of `kubernetes_tpu/server/controlplane.py`: the same
behaviour, names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from ..store import APIStore
from ..utils.leaderelection import LeaderElector

# how long a stopping replica waits for one component's thread to exit
STOP_TIMEOUT_S = 60.0

DEFAULT_CONTROLLERS = (
    "deployment", "replicaset", "statefulset", "daemonset", "job", "cronjob",
    "disruption", "nodelifecycle", "tainteviction", "endpointslice",
    "namespace", "garbagecollector", "resourcequota", "horizontalpodautoscaler",
    "serviceaccount", "ttlafterfinished", "eventttl", "csrapproving",
    "csrcleaner", "podgc", "persistentvolumebinder", "attachdetach",
    "resourceclaim", "apiserviceavailability",
)


def _controller_registry():
    from ..controllers import (
        CSRApprovingController,
        CSRCleanerController,
        CronJobController,
        DaemonSetController,
        DeploymentController,
        DisruptionController,
        EndpointSliceController,
        GarbageCollector,
        HorizontalPodAutoscalerController,
        JobController,
        NamespaceController,
        NodeLifecycleController,
        PodGCController,
        ReplicaSetController,
        ResourceQuotaController,
        EventTTLController,
        ServiceAccountController,
        StatefulSetController,
        TaintEvictionController,
        TTLAfterFinishedController,
        APIServiceAvailabilityController,
        AttachDetachController,
        PersistentVolumeBinder,
        ResourceClaimController,
    )

    return {
        "csrapproving": CSRApprovingController,
        "csrcleaner": CSRCleanerController,
        "serviceaccount": ServiceAccountController,
        "ttlafterfinished": TTLAfterFinishedController,
        "eventttl": EventTTLController,
        "deployment": DeploymentController,
        "replicaset": ReplicaSetController,
        "statefulset": StatefulSetController,
        "daemonset": DaemonSetController,
        "job": JobController,
        "cronjob": CronJobController,
        "disruption": DisruptionController,
        "nodelifecycle": NodeLifecycleController,
        "podgc": PodGCController,
        "tainteviction": TaintEvictionController,
        "endpointslice": EndpointSliceController,
        "namespace": NamespaceController,
        "garbagecollector": GarbageCollector,
        "resourcequota": ResourceQuotaController,
        "horizontalpodautoscaler": HorizontalPodAutoscalerController,
        "persistentvolumebinder": PersistentVolumeBinder,
        "attachdetach": AttachDetachController,
        "resourceclaim": ResourceClaimController,
        "apiserviceavailability": APIServiceAvailabilityController,
    }


class ControlPlane:
    """One control-plane replica. start() joins the election; the winner runs
    the scheduler + the controller set, a loser idles hot. Losing the lease
    stops everything mid-flight (the reference's leaderelection OnStoppedLeading
    exits the process; in-process we stop the loops so a standby's writes can't
    interleave with ours — no double binds)."""

    def __init__(self, store: APIStore, identity: str,
                 controllers: tuple = DEFAULT_CONTROLLERS,
                 use_batch_scheduler: bool = True,
                 scheduler_factory: Optional[Callable] = None,
                 lease_duration: float = 15.0, renew_deadline: float = 10.0,
                 retry_period: float = 2.0, signer=None, device="cuda"):
        from ..ops.solver import resolve_device

        self.store = store
        self.device = resolve_device(device)
        self.identity = identity
        # cluster credential signer (auth.SignedTokenAuthenticator); when set,
        # the leader also runs the CSR signing controller
        self.signer = signer
        self.controller_names = tuple(controllers)
        self.use_batch_scheduler = use_batch_scheduler
        self.scheduler_factory = scheduler_factory
        self.scheduler = None
        self.controllers: List = []
        self._lock = threading.Lock()
        self.elector = LeaderElector(
            store, lock_name="kube-controlplane", identity=identity,
            lease_duration=lease_duration, renew_deadline=renew_deadline,
            retry_period=retry_period,
            on_started_leading=self._start_components,
            on_stopped_leading=self._stop_components,
        )

    @property
    def is_leader(self) -> bool:
        return self.elector.is_leader

    def _build_scheduler(self):
        if self.scheduler_factory is not None:
            return self.scheduler_factory(self.store)
        from ..scheduler.runtime import Framework
        from ..scheduler.plugins import default_plugins

        if self.use_batch_scheduler:
            from ..scheduler.batch import BatchScheduler

            return BatchScheduler(self.store, Framework(default_plugins()),
                                  solver="auto", device=self.device)
        from ..scheduler.serial import Scheduler

        return Scheduler(self.store, Framework(default_plugins()))

    def _start_components(self) -> None:
        with self._lock:
            registry = _controller_registry()
            self.scheduler = self._build_scheduler()
            self.scheduler.sync()
            self.scheduler.start()
            self.controllers = []
            for name in self.controller_names:
                c = registry[name](self.store)
                c.sync_all()
                c.start()
                self.controllers.append(c)
            if self.signer is not None:
                from ..controllers import CSRSigningController

                c = CSRSigningController(self.store, self.signer)
                c.sync_all()
                c.start()
                self.controllers.append(c)

    def _stop_components(self) -> None:
        """Stop the scheduler and the controllers all at once and wait until
        every one of their threads has exited: a replica stops in the time of
        its slowest loop, not their sum, and writes nothing after (the JAX
        package stops them one by one, each join capped at 2 s)."""
        with self._lock:
            parts = ([self.scheduler] if self.scheduler is not None else []) + self.controllers
            loops = [t for t in (getattr(p, "_thread", None) for p in parts) if t is not None]
            stoppers = [threading.Thread(target=p.stop, name=f"{self.identity}-stop")
                        for p in parts]
            for t in stoppers:
                t.start()
            for t in stoppers + loops:
                t.join(timeout=STOP_TIMEOUT_S)
            self.scheduler = None
            self.controllers = []

    def start(self) -> "ControlPlane":
        self.elector.start()
        return self

    def stop(self) -> None:
        """Stop the components while this replica still holds and renews the
        lease, then release it: a standby cannot lead while they write. (The
        JAX package releases the lease first, so for the seconds its
        components take to stop both replicas lead, ROADMAP.md queue 3.)"""
        self._stop_components()
        self.elector.stop()  # releases the lease
        self._stop_components()  # what the elector started meanwhile, if it won the lease

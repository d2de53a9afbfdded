"""L4 — reconciling control loops (reference: pkg/controller).

The counterpart of `kubernetes_tpu/controllers/`, with its whole export
list: the workload controllers (ReplicaSet, Deployment, DaemonSet,
StatefulSet, Job and CronJob), taint eviction, node lifecycle, disruption
budgets, the garbage collector and PodGC, and the service and tenant
controllers (namespace, service account, TTL-after-finished, event TTL,
resource quota, endpoint slices, the horizontal pod autoscaler), the volume
controllers (PV binder, attach/detach), the resource-claim controller, the
certificate approver, signer and cleaner, and the API-service availability
probe.

Drive a controller with `sync_all()` once, then `reconcile_once()` (pump the
watch, process the dirty keys) or `run_until_stable()`; `start()` / `stop()`
run the same loop on a thread.
"""

from .certificates import (  # noqa: F401
    CSRApprovingController,
    CSRCleanerController,
    CSRSigningController,
)
from .apiservice import APIServiceAvailabilityController  # noqa: F401
from .base import Controller  # noqa: F401
from .daemonset import DaemonSetController  # noqa: F401
from .deployment import DeploymentController  # noqa: F401
from .disruption import DisruptionController  # noqa: F401
from .endpointslice import EndpointSliceController  # noqa: F401
from .garbagecollector import GarbageCollector  # noqa: F401
from .job import CronJobController, JobController  # noqa: F401
from .namespace import NamespaceController  # noqa: F401
from .node_lifecycle import NodeLifecycleController  # noqa: F401
from .podgc import PodGCController  # noqa: F401
from .podautoscaler import HorizontalPodAutoscalerController  # noqa: F401
from .replicaset import ReplicaSetController  # noqa: F401
from .resourceclaim import ResourceClaimController  # noqa: F401
from .resourcequota import ResourceQuotaController  # noqa: F401
from .serviceaccount import (  # noqa: F401
    EventTTLController,
    ServiceAccountController,
    TTLAfterFinishedController,
)
from .statefulset import StatefulSetController  # noqa: F401
from .volume import AttachDetachController, PersistentVolumeBinder  # noqa: F401
from .tainteviction import TaintEvictionController  # noqa: F401

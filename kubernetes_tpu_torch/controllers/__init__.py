"""The workload control loop: owner references, the workload controllers and
the failure-detection loop.

The counterpart of `kubernetes_tpu/controllers/` for the controllers a
Deployment's life runs through: ReplicaSet and Deployment (rollout,
rollback, scale), DaemonSet, StatefulSet, Job and CronJob, taint eviction,
node lifecycle, disruption budgets, the garbage collector and PodGC. The
namespace, endpoint-slice, quota, autoscaling, service-account,
certificate, API-service, resource-claim and volume controllers come with
ROADMAP.md queue 1 item 7j.

Drive a controller with `sync_all()` once, then `reconcile_once()` (pump the
watch, process the dirty keys) or `run_until_stable()`; `start()` / `stop()`
run the same loop on a thread.
"""

from .base import Controller  # noqa: F401
from .daemonset import DaemonSetController  # noqa: F401
from .deployment import DeploymentController  # noqa: F401
from .disruption import DisruptionController  # noqa: F401
from .garbagecollector import GarbageCollector  # noqa: F401
from .job import CronJobController, JobController  # noqa: F401
from .node_lifecycle import NodeLifecycleController  # noqa: F401
from .podgc import PodGCController  # noqa: F401
from .replicaset import ReplicaSetController  # noqa: F401
from .statefulset import StatefulSetController  # noqa: F401
from .tainteviction import TaintEvictionController  # noqa: F401

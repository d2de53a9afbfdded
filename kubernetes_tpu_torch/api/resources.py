"""Resource quantities and per-pod/node resource accounting.

Re-provides the semantics of k8s resource.Quantity parsing
(reference: staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go) and the
scheduler's Resource struct (reference: pkg/scheduler/framework/types.go:1027
`Resource` with MilliCPU/Memory/EphemeralStorage/AllowedPodNumber/ScalarResources),
including the pod-request aggregation rule
max(sum(containers), max(initContainers)) + overhead
(reference: pkg/scheduler/framework/plugins/noderesources/fit.go:218
`computePodResourceRequest`) and the non-zero defaults used for scoring
(reference: pkg/scheduler/util/pod_resources.go DefaultMilliCPURequest=100m,
DefaultMemoryRequest=200Mi).

Internal canonical unit: integer *milli* base-units (1 CPU = 1000 mCPU; 1 byte of
memory = 1000 milli-bytes) so fractional quantities like "0.5" and "100m" stay exact.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, Mapping, Optional

# Well-known resource names (reference: staging/src/k8s.io/api/core/v1/types.go
# ResourceCPU/ResourceMemory/ResourceEphemeralStorage/ResourcePods).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

# Defaults for scoring best-effort containers (reference:
# pkg/scheduler/util/pod_resources.go:29-35).
DEFAULT_MILLI_CPU_REQUEST = 100  # 0.1 core
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024  # 200 MiB

_BINARY_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIX = {
    "n": 10**-9,
    "u": 10**-6,
    "m": 10**-3,
    "": 1,
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<exp>[eE][+-]?\d+)|(?P<suffix>Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E))?$"
)


def parse_quantity_milli(s) -> int:
    """Parse a k8s quantity string into integer milli base-units.

    "100m" -> 100; "1" -> 1000; "1Gi" -> 1024**3 * 1000; 2.5 -> 2500.
    Accepts int/float for convenience (interpreted as whole base-units).
    """
    if isinstance(s, bool):
        raise ValueError(f"invalid quantity: {s!r}")
    if isinstance(s, int):
        return s * 1000
    if isinstance(s, float):
        return round(s * 1000)
    s = s.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    sign = -1 if m.group("sign") == "-" else 1
    num = m.group("num")
    if m.group("exp"):
        mult = 10 ** int(m.group("exp")[1:])
    elif m.group("suffix") in _BINARY_SUFFIX:
        mult = _BINARY_SUFFIX[m.group("suffix")]
    else:
        mult = _DECIMAL_SUFFIX[m.group("suffix") or ""]
    # Exact integer math: split decimal part to avoid float error.
    if "." in num:
        int_part, frac_part = num.split(".")
        int_part = int(int_part or "0")
        frac_den = 10 ** len(frac_part)
        frac_num = int(frac_part or "0")
        # value = (int_part + frac_num/frac_den) * mult * 1000
        if isinstance(mult, float):
            return sign * round((int_part + frac_num / frac_den) * mult * 1000)
        total = int_part * mult * 1000 + frac_num * mult * 1000 // frac_den
        return sign * total
    if isinstance(mult, float):
        return sign * round(int(num) * mult * 1000)
    return sign * int(num) * mult * 1000


def _ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


def quantity_value(s) -> int:
    """Whole base-units, rounded up (k8s Quantity.Value semantics)."""
    return _ceil_div(parse_quantity_milli(s), 1000)


def quantity_milli_value(s) -> int:
    """Milli base-units (k8s Quantity.MilliValue semantics)."""
    return parse_quantity_milli(s)


def is_scalar_resource_name(name: str) -> bool:
    """Extended/attachable resources tracked in ScalarResources
    (reference: pkg/apis/core/v1/helper/helpers.go IsScalarResourceName)."""
    return name not in (CPU, MEMORY, EPHEMERAL_STORAGE, PODS)


@dataclass
class Resource:
    """Scheduler-internal resource vector.

    Mirrors the semantics of framework.Resource (reference:
    pkg/scheduler/framework/types.go:1027): CPU in millicores, memory and
    ephemeral-storage in bytes, pod-count slot, and a map of scalar resources.
    """

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar: Dict[str, int] = field(default_factory=dict)

    def clone(self) -> "Resource":
        return Resource(
            self.milli_cpu,
            self.memory,
            self.ephemeral_storage,
            self.allowed_pod_number,
            dict(self.scalar),
        )

    def add(self, other: "Resource") -> None:
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.ephemeral_storage += other.ephemeral_storage
        for k, v in other.scalar.items():
            self.scalar[k] = self.scalar.get(k, 0) + v

    def sub(self, other: "Resource") -> None:
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.ephemeral_storage -= other.ephemeral_storage
        for k, v in other.scalar.items():
            self.scalar[k] = self.scalar.get(k, 0) - v

    def set_max(self, other: "Resource") -> None:
        """Component-wise max (used for init-container aggregation)."""
        self.milli_cpu = max(self.milli_cpu, other.milli_cpu)
        self.memory = max(self.memory, other.memory)
        self.ephemeral_storage = max(self.ephemeral_storage, other.ephemeral_storage)
        for k, v in other.scalar.items():
            self.scalar[k] = max(self.scalar.get(k, 0), v)

    @staticmethod
    def from_resource_list(rl: Optional[Mapping[str, object]]) -> "Resource":
        """Build from a k8s ResourceList mapping (e.g. {"cpu": "500m", "memory": "1Gi"}).

        CPU -> MilliValue; everything else -> Value (bytes / counts), matching
        framework.Resource.Add (reference: pkg/scheduler/framework/types.go:1060).
        """
        r = Resource()
        if not rl:
            return r
        for name, q in rl.items():
            if name == CPU:
                r.milli_cpu += quantity_milli_value(q)
            elif name == MEMORY:
                r.memory += quantity_value(q)
            elif name == EPHEMERAL_STORAGE:
                r.ephemeral_storage += quantity_value(q)
            elif name == PODS:
                r.allowed_pod_number += quantity_value(q)
            else:
                r.scalar[name] = r.scalar.get(name, 0) + quantity_value(q)
        return r

    def get(self, name: str) -> int:
        if name == CPU:
            return self.milli_cpu
        if name == MEMORY:
            return self.memory
        if name == EPHEMERAL_STORAGE:
            return self.ephemeral_storage
        if name == PODS:
            return self.allowed_pod_number
        return self.scalar.get(name, 0)

    def resource_names(self) -> Iterable[str]:
        names = []
        if self.milli_cpu:
            names.append(CPU)
        if self.memory:
            names.append(MEMORY)
        if self.ephemeral_storage:
            names.append(EPHEMERAL_STORAGE)
        names.extend(self.scalar.keys())
        return names


def compute_pod_resource_request(pod, non_zero: bool = False) -> Resource:
    """Aggregate a pod's resource request.

    max(sum(app containers), max(init containers)) + overhead — the rule in
    fit.go:218 `computePodResourceRequest` / resource_helpers. With non_zero=True,
    best-effort cpu/memory get the scoring defaults (reference:
    pkg/scheduler/util/pod_resources.go GetNonzeroRequests), used for
    NonZeroRequested accounting in NodeInfo.
    """
    total = Resource()
    for c in pod.spec.containers:
        total.add(_container_request(c, non_zero))
    # Non-zero defaults apply to init containers too (reference:
    # pkg/scheduler/framework/types.go:1131-1146 NonMissingContainerRequests).
    init_max = Resource()
    for c in pod.spec.init_containers:
        init_max.set_max(_container_request(c, non_zero))
    total.set_max(init_max)
    if pod.spec.overhead:
        total.add(Resource.from_resource_list(pod.spec.overhead))
    return total


def _container_request(container, non_zero: bool) -> Resource:
    r = Resource.from_resource_list(container.resources.get("requests"))
    if non_zero:
        if r.milli_cpu == 0:
            r.milli_cpu = DEFAULT_MILLI_CPU_REQUEST
        if r.memory == 0:
            r.memory = DEFAULT_MEMORY_REQUEST
    return r

"""Pod Security admission: namespace-labelled baseline/restricted levels.

reference: staging/src/k8s.io/pod-security-admission — policy/check_*.go for
the per-field checks, admission/admission.go for the namespace-label
evaluation. The subset carried here is the enforce mode with the checks that
map onto this build's Pod surface:

baseline  — no privileged containers, no host namespaces (hostNetwork/PID/
            IPC), no hostPath volumes, no hostPorts, capability adds limited
            to the baseline allow-list, no Unconfined seccomp.
restricted — baseline plus: runAsNonRoot required, allowPrivilegeEscalation
            must be false, capabilities must drop ALL (only NET_BIND_SERVICE
            may be added back), volume sources limited to the restricted set.

Namespaces opt in via the standard labels:
    pod-security.kubernetes.io/enforce: privileged | baseline | restricted
Unlabelled namespaces are `privileged` (no enforcement), like the reference's
default when no exemption/configuration says otherwise.

The counterpart of `kubernetes_tpu/server/podsecurity.py`: the same
behaviour, names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

from typing import Any, Dict, List

ENFORCE_LABEL = "pod-security.kubernetes.io/enforce"
LEVELS = ("privileged", "baseline", "restricted")

# capability adds baseline tolerates (policy/check_capabilities_baseline.go)
BASELINE_CAPABILITIES = {
    "AUDIT_WRITE", "CHOWN", "DAC_OVERRIDE", "FOWNER", "FSETID", "KILL",
    "MKNOD", "NET_BIND_SERVICE", "SETFCAP", "SETGID", "SETPCAP", "SETUID",
    "SYS_CHROOT",
}

# volume sources restricted forbids beyond baseline
# (policy/check_restrictedVolumes.go); hostPath is already a baseline
# violation so it is not repeated here
_FORBIDDEN_RESTRICTED_VOLUME_FIELDS = (
    ("gce_pd", "gcePersistentDisk"),
    ("aws_ebs", "awsElasticBlockStore"),
    ("rbd", "rbd"),
    ("iscsi", "iscsi"),
)


def _containers(pod) -> List:
    return list(pod.spec.containers) + list(pod.spec.init_containers)


def _sc(container) -> Dict[str, Any]:
    return container.security_context or {}


def _effective(pod, container, key):
    """Container securityContext wins over pod securityContext (core/v1
    precedence for the fields both levels define)."""
    if key in _sc(container):
        return _sc(container)[key]
    return (pod.spec.security_context or {}).get(key)


def check_baseline(pod) -> List[str]:
    errs: List[str] = []
    if pod.spec.host_network:
        errs.append("hostNetwork is not allowed")
    if pod.spec.host_pid:
        errs.append("hostPID is not allowed")
    if pod.spec.host_ipc:
        errs.append("hostIPC is not allowed")
    for v in pod.spec.volumes:
        if v.host_path:
            errs.append(f"hostPath volume {v.name!r} is not allowed")
    for c in _containers(pod):
        sc = _sc(c)
        if sc.get("privileged"):
            errs.append(f"container {c.name!r}: privileged is not allowed")
        adds = ((sc.get("capabilities") or {}).get("add")) or []
        bad = [a for a in adds if a not in BASELINE_CAPABILITIES]
        if bad:
            errs.append(f"container {c.name!r}: capabilities {bad} not allowed")
        seccomp = _effective(pod, c, "seccompProfile") or {}
        if seccomp.get("type") == "Unconfined":
            errs.append(f"container {c.name!r}: seccompProfile Unconfined "
                        "is not allowed")
        for p in c.ports:
            if p.host_port:
                errs.append(f"container {c.name!r}: hostPort {p.host_port} "
                            "is not allowed")
    return errs


def check_restricted(pod) -> List[str]:
    errs = check_baseline(pod)
    for attr, wire in _FORBIDDEN_RESTRICTED_VOLUME_FIELDS:
        for v in pod.spec.volumes:
            if getattr(v, attr):
                errs.append(f"volume {v.name!r}: {wire} is not allowed")
    for c in _containers(pod):
        sc = _sc(c)
        if _effective(pod, c, "runAsNonRoot") is not True:
            errs.append(f"container {c.name!r}: runAsNonRoot must be true")
        if sc.get("allowPrivilegeEscalation") is not False:
            errs.append(f"container {c.name!r}: allowPrivilegeEscalation "
                        "must be false")
        caps = sc.get("capabilities") or {}
        drops = caps.get("drop") or []
        if "ALL" not in drops:
            errs.append(f"container {c.name!r}: capabilities must drop ALL")
        adds = caps.get("add") or []
        bad = [a for a in adds if a != "NET_BIND_SERVICE"]
        if bad:
            errs.append(f"container {c.name!r}: may only add NET_BIND_SERVICE, "
                        f"got {bad}")
        seccomp = _effective(pod, c, "seccompProfile") or {}
        if seccomp.get("type") not in ("RuntimeDefault", "Localhost"):
            errs.append(f"container {c.name!r}: seccompProfile must be "
                        "RuntimeDefault or Localhost")
    return errs


def check_level(level: str, pod) -> List[str]:
    if level == "baseline":
        return check_baseline(pod)
    if level == "restricted":
        return check_restricted(pod)
    return []

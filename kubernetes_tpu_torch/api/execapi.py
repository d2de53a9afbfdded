"""Exec / attach / port-forward session objects — the streaming channel.

reference: pkg/kubelet/server/server.go serves exec/attach/portforward over
SPDY/websocket streams and kubectl dials them through the apiserver proxy
(kubectl/pkg/cmd/exec/exec.go). This build replaces the byte-stream
transport with STORE-CHANNEL sessions, the same pattern the PodLog channel
proved for `ktl logs`: the client POSTs the pod's exec subresource, the API
server creates a PodExec session object, the kubelet that owns the pod
watches sessions, runs the command against its CRI runtime, and writes the
result into the session; the API server long-polls the session and returns
stdout/stderr/exitCode. stdin rides in the session spec (bidirectional:
client bytes in spec, container bytes in status). Sessions are owned by
their pod (GC'd with it) and deleted by the server after the round-trip.

PodPortForward is the same channel carrying opaque bytes for one
connection round: local socket bytes -> spec.data, remote answer ->
status.data (kubectl port-forward's data channel, one exchange per
request).

The counterpart of `kubernetes_tpu/api/execapi.py`: the same names, defaults
and wire forms, held equal to it by the port's tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from .types import ObjectMeta

# the command marking "attach to the running container" instead of spawning
# one (kubelet server.go attach handler); the kubelet answers with the
# container's recent output and feeds stdin to the container
ATTACH_COMMAND = "__attach__"


@dataclass
class PodExec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_name: str = ""
    container: str = ""
    command: List[str] = field(default_factory=list)
    stdin: str = ""
    tty: bool = False
    # status
    stdout: str = ""
    stdout_b64: str = ""  # byte-faithful copy (text stdout is lossy for
    # binary content — ktl cp reads this)
    stderr: str = ""
    exit_code: Optional[int] = None
    done: bool = False
    error: str = ""

    kind = "PodExec"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "PodExec":
        spec = d.get("spec") or {}
        st = d.get("status") or {}
        return PodExec(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            pod_name=spec.get("podName", ""),
            container=spec.get("container", ""),
            command=list(spec.get("command") or []),
            stdin=spec.get("stdin", ""),
            tty=bool(spec.get("tty", False)),
            stdout=st.get("stdout", ""),
            stdout_b64=st.get("stdoutB64", ""),
            stderr=st.get("stderr", ""),
            exit_code=st.get("exitCode"),
            done=bool(st.get("done", False)),
            error=st.get("error", ""),
        )

    def to_dict(self) -> Dict[str, Any]:
        status: Dict[str, Any] = {"done": self.done}
        if self.stdout:
            status["stdout"] = self.stdout
        if self.stdout_b64:
            status["stdoutB64"] = self.stdout_b64
        if self.stderr:
            status["stderr"] = self.stderr
        if self.exit_code is not None:
            status["exitCode"] = self.exit_code
        if self.error:
            status["error"] = self.error
        return {"apiVersion": "v1", "kind": self.kind,
                "metadata": self.metadata.to_dict(),
                "spec": {"podName": self.pod_name,
                         "container": self.container,
                         "command": list(self.command),
                         **({"stdin": self.stdin} if self.stdin else {}),
                         **({"tty": True} if self.tty else {})},
                "status": status}


@dataclass
class PodPortForward:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_name: str = ""
    port: int = 0
    data: str = ""  # base64 request bytes (one connection round)
    # status
    response: str = ""  # base64 response bytes
    done: bool = False
    error: str = ""

    kind = "PodPortForward"

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @staticmethod
    def from_dict(d: Mapping) -> "PodPortForward":
        spec = d.get("spec") or {}
        st = d.get("status") or {}
        return PodPortForward(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            pod_name=spec.get("podName", ""),
            port=int(spec.get("port", 0) or 0),
            data=spec.get("data", ""),
            response=st.get("data", ""),
            done=bool(st.get("done", False)),
            error=st.get("error", ""),
        )

    def to_dict(self) -> Dict[str, Any]:
        status: Dict[str, Any] = {"done": self.done}
        if self.response:
            status["data"] = self.response
        if self.error:
            status["error"] = self.error
        return {"apiVersion": "v1", "kind": self.kind,
                "metadata": self.metadata.to_dict(),
                "spec": {"podName": self.pod_name, "port": self.port,
                         **({"data": self.data} if self.data else {})},
                "status": status}

"""ConfigMap + Secret — the core configuration-payload types.

reference: staging/src/k8s.io/api/core/v1/types.go (ConfigMap ~line 4650,
Secret ~line 4450). Secrets carry base64 `data` on the wire with a write-only
`stringData` convenience field folded into `data` on ingest
(pkg/apis/core/v1/conversion + registry strategy); both support `immutable`,
enforced on update (pkg/apis/core/validation/validation.go
ValidateConfigMapUpdate/ValidateSecretUpdate) — the immutability check here
lives in the admission chain so every write path shares it.

The counterpart of `kubernetes_tpu/api/config.py`: the same names, defaults
and wire forms, held equal to it by the port's tests.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

from .types import ObjectMeta

SECRET_OPAQUE = "Opaque"
SECRET_SERVICE_ACCOUNT_TOKEN = "kubernetes.io/service-account-token"


@dataclass
class ConfigMap:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)
    binary_data: Dict[str, str] = field(default_factory=dict)  # b64 values
    immutable: bool = False

    kind = "ConfigMap"

    @staticmethod
    def from_dict(d: Mapping) -> "ConfigMap":
        return ConfigMap(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            data={k: str(v) for k, v in (d.get("data") or {}).items()},
            binary_data=dict(d.get("binaryData") or {}),
            immutable=bool(d.get("immutable", False)),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"apiVersion": "v1", "kind": "ConfigMap",
                               "metadata": self.metadata.to_dict()}
        if self.data:
            out["data"] = dict(self.data)
        if self.binary_data:
            out["binaryData"] = dict(self.binary_data)
        if self.immutable:
            out["immutable"] = True
        return out


@dataclass
class Secret:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = SECRET_OPAQUE
    data: Dict[str, str] = field(default_factory=dict)  # b64-encoded values
    immutable: bool = False

    kind = "Secret"

    @staticmethod
    def from_dict(d: Mapping) -> "Secret":
        data = {k: str(v) for k, v in (d.get("data") or {}).items()}
        # stringData is WRITE-ONLY plaintext convenience: folded into data
        # (base64) on ingest, wins over a same-key data entry, never echoed
        for k, v in (d.get("stringData") or {}).items():
            data[k] = base64.b64encode(str(v).encode()).decode()
        return Secret(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            type=d.get("type", SECRET_OPAQUE),
            data=data,
            immutable=bool(d.get("immutable", False)),
        )

    def decoded(self, key: str) -> Optional[str]:
        raw = self.data.get(key)
        if raw is None:
            return None
        return base64.b64decode(raw).decode()

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"apiVersion": "v1", "kind": "Secret",
                               "metadata": self.metadata.to_dict(),
                               "type": self.type}
        if self.data:
            out["data"] = dict(self.data)
        if self.immutable:
            out["immutable"] = True
        return out

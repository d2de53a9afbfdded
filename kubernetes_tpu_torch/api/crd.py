"""CustomResourceDefinitions: dynamic API types served without code.

reference: staging/src/k8s.io/apiextensions-apiserver/pkg/apis/apiextensions/
types.go (CustomResourceDefinition{Spec,Names,Version}) and
pkg/apiserver/schema/ (structural schemas: validation + defaulting). The
reference runs a second aggregated apiserver; here the same store serves
dynamic kinds directly — a CRD create makes `/apis/{group}/{version}/{plural}`
live on the next request, with structural-schema validation and defaulting on
writes and full list/watch/patch semantics inherited from the store.

Custom objects are held as `Unstructured`: typed ObjectMeta (so the store,
namespace lifecycle, GC owner references, and field selectors work unchanged)
plus the raw spec/status payload as plain dicts — there is no codegen step and
none is needed; the tensorizer never sees these objects unless a scheduler
plugin opts in.

The counterpart of `kubernetes_tpu/api/crd.py`: the same names, defaults and
wire forms, held equal to it by the port's tests.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from .types import ObjectMeta


@dataclass
class CRDNames:
    """reference: apiextensions/types.go CustomResourceDefinitionNames."""

    plural: str = ""
    singular: str = ""
    kind: str = ""
    list_kind: str = ""
    short_names: List[str] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Mapping) -> "CRDNames":
        return CRDNames(
            plural=d.get("plural", ""),
            singular=d.get("singular", ""),
            kind=d.get("kind", ""),
            list_kind=d.get("listKind", ""),
            short_names=list(d.get("shortNames") or []),
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"plural": self.plural, "kind": self.kind}
        if self.singular:
            out["singular"] = self.singular
        if self.list_kind:
            out["listKind"] = self.list_kind
        if self.short_names:
            out["shortNames"] = list(self.short_names)
        return out


@dataclass
class CRDVersion:
    """One served version; `schema` is the openAPIV3Schema dict (structural
    subset — see validate_structural)."""

    name: str = "v1"
    served: bool = True
    storage: bool = True
    schema: Optional[Dict[str, Any]] = None

    @staticmethod
    def from_dict(d: Mapping) -> "CRDVersion":
        schema = None
        if d.get("schema"):
            schema = d["schema"].get("openAPIV3Schema")
        return CRDVersion(
            name=d.get("name", "v1"),
            served=bool(d.get("served", True)),
            storage=bool(d.get("storage", True)),
            schema=schema,
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "served": self.served,
                               "storage": self.storage}
        if self.schema is not None:
            out["schema"] = {"openAPIV3Schema": self.schema}
        return out


@dataclass
class CustomResourceDefinition:
    """Cluster-scoped; metadata.name must be `<plural>.<group>`
    (reference: apiextensions validation.ValidateCustomResourceDefinition)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    group: str = ""
    scope: str = "Namespaced"  # or "Cluster"
    names: CRDNames = field(default_factory=CRDNames)
    versions: List[CRDVersion] = field(default_factory=list)

    kind = "CustomResourceDefinition"

    def __post_init__(self):
        self.metadata.namespace = ""  # cluster-scoped: one store key scheme

    def validate(self) -> Optional[str]:
        if not self.group or "." not in self.group:
            return f"spec.group must be a DNS domain, got {self.group!r}"
        if not self.names.plural:
            return "spec.names.plural is required"
        if not self.names.kind:
            return "spec.names.kind is required"
        if self.scope not in ("Namespaced", "Cluster"):
            return f"spec.scope must be Namespaced or Cluster, got {self.scope!r}"
        want = f"{self.names.plural}.{self.group}"
        if self.metadata.name != want:
            return (f"metadata.name must be spec.names.plural+\".\"+spec.group: "
                    f"expected {want!r}, got {self.metadata.name!r}")
        if not self.versions:
            return "spec.versions must have at least one version"
        if sum(1 for v in self.versions if v.storage) != 1:
            return "exactly one version must have storage=true"
        return None

    def served_version(self) -> Optional[CRDVersion]:
        for v in self.versions:
            if v.storage and v.served:
                return v
        for v in self.versions:
            if v.served:
                return v
        return None

    @property
    def group_prefix(self) -> str:
        v = self.served_version()
        return f"/apis/{self.group}/{v.name if v else 'v1'}"

    @staticmethod
    def from_dict(d: Mapping) -> "CustomResourceDefinition":
        spec = d.get("spec") or {}
        return CustomResourceDefinition(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            group=spec.get("group", ""),
            scope=spec.get("scope", "Namespaced"),
            names=CRDNames.from_dict(spec.get("names") or {}),
            versions=[CRDVersion.from_dict(v) for v in spec.get("versions") or []],
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "apiextensions.k8s.io/v1",
            "kind": "CustomResourceDefinition",
            "metadata": self.metadata.to_dict(),
            "spec": {
                "group": self.group,
                "scope": self.scope,
                "names": self.names.to_dict(),
                "versions": [v.to_dict() for v in self.versions],
            },
        }


@dataclass
class Unstructured:
    """A dynamic object: typed metadata + raw payload. The payload keeps every
    top-level field except apiVersion/kind/metadata (spec, status, data, ...)."""

    api_version: str = ""
    kind: str = ""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    content: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_dict(d: Mapping) -> "Unstructured":
        content = {k: v for k, v in d.items()
                   if k not in ("apiVersion", "kind", "metadata")}
        return Unstructured(
            api_version=d.get("apiVersion", ""),
            kind=d.get("kind", ""),
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            content=content,
        )

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"apiVersion": self.api_version, "kind": self.kind,
                               "metadata": self.metadata.to_dict()}
        out.update(self.content)
        return out

    def get(self, key: str, default=None):
        return self.content.get(key, default)


# ---- structural-schema validation + defaulting --------------------------------
#
# The subset of OpenAPI v3 the reference calls "structural"
# (apiextensions-apiserver/pkg/apiserver/schema/structural.go): type,
# properties, required, items, enum, minimum/maximum, minLength/maxLength,
# minItems/maxItems, pattern, additionalProperties, default, and
# x-kubernetes-preserve-unknown-fields. Unknown fields are PRUNED (the v1
# default) unless preserve-unknown-fields is set.

_TYPE_CHECKS = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "integer": lambda v: isinstance(v, int) and not isinstance(v, bool),
    "number": lambda v: isinstance(v, (int, float)) and not isinstance(v, bool),
    "boolean": lambda v: isinstance(v, bool),
}


def validate_structural(schema: Optional[Mapping], value: Any,
                        path: str = "") -> List[str]:
    """-> list of error strings (empty = valid)."""
    if schema is None:
        return []
    errs: List[str] = []
    loc = path or "<root>"
    t = schema.get("type")
    if t:
        check = _TYPE_CHECKS.get(t)
        if check is None:
            errs.append(f"{loc}: unknown schema type {t!r}")
            return errs
        if not check(value):
            errs.append(f"{loc}: expected {t}, got {type(value).__name__}")
            return errs
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{loc}: {value!r} not in enum {schema['enum']!r}")
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if "minimum" in schema and value < schema["minimum"]:
            errs.append(f"{loc}: {value} < minimum {schema['minimum']}")
        if "maximum" in schema and value > schema["maximum"]:
            errs.append(f"{loc}: {value} > maximum {schema['maximum']}")
    if isinstance(value, str):
        if "minLength" in schema and len(value) < schema["minLength"]:
            errs.append(f"{loc}: length {len(value)} < minLength {schema['minLength']}")
        if "maxLength" in schema and len(value) > schema["maxLength"]:
            errs.append(f"{loc}: length {len(value)} > maxLength {schema['maxLength']}")
        if "pattern" in schema and not re.search(schema["pattern"], value):
            errs.append(f"{loc}: does not match pattern {schema['pattern']!r}")
    if isinstance(value, list):
        if "minItems" in schema and len(value) < schema["minItems"]:
            errs.append(f"{loc}: {len(value)} items < minItems {schema['minItems']}")
        if "maxItems" in schema and len(value) > schema["maxItems"]:
            errs.append(f"{loc}: {len(value)} items > maxItems {schema['maxItems']}")
        items = schema.get("items")
        if items is not None:
            for i, v in enumerate(value):
                errs.extend(validate_structural(items, v, f"{path}[{i}]"))
    if isinstance(value, dict):
        props = schema.get("properties") or {}
        for k in schema.get("required") or []:
            if k not in value:
                errs.append(f"{loc}: required field {k!r} missing")
        for k, v in value.items():
            sub = props.get(k)
            if sub is not None:
                errs.extend(validate_structural(sub, v, f"{path}.{k}" if path else k))
            elif isinstance(schema.get("additionalProperties"), dict):
                errs.extend(validate_structural(schema["additionalProperties"], v,
                                                f"{path}.{k}" if path else k))
    return errs


def prune_and_default(schema: Optional[Mapping], value: Any) -> Any:
    """Apply defaults for absent properties and prune unknown fields
    (reference: schema/defaulting/algorithm.go + pruning/algorithm.go).
    Returns the new value; does not mutate the input."""
    if schema is None or not isinstance(schema, Mapping):
        return value
    if isinstance(value, dict):
        props = schema.get("properties") or {}
        ap = schema.get("additionalProperties")
        # additionalProperties: false means PRUNE unknowns (not preserve);
        # a schema or true means keep; bare objects with no properties keep
        # everything (free-form maps)
        preserve = (schema.get("x-kubernetes-preserve-unknown-fields")
                    or isinstance(ap, Mapping) or ap is True
                    or (not props and ap is not False))
        out = {}
        for k, v in value.items():
            if k in props:
                out[k] = prune_and_default(props[k], v)
            elif preserve:
                ap = schema.get("additionalProperties")
                out[k] = prune_and_default(ap if isinstance(ap, Mapping) else None, v)
        for k, sub in props.items():
            if k not in out and isinstance(sub, Mapping) and "default" in sub:
                out[k] = sub["default"]
        return out
    if isinstance(value, list) and schema.get("items") is not None:
        return [prune_and_default(schema["items"], v) for v in value]
    return value


class DynamicRegistry:
    """plural -> CustomResourceDefinition, kept current by draining a store
    watch on `customresourcedefinitions` (no polling, no per-request relist —
    the informer pattern applied in-process)."""

    RESOURCE = "customresourcedefinitions"

    def __init__(self, store):
        self._store = store
        self._lock = threading.Lock()
        self._by_plural: Dict[str, CustomResourceDefinition] = {}
        self._by_name: Dict[str, CustomResourceDefinition] = {}  # metadata.name
        self._short: Dict[str, str] = {}  # shortName/singular/kind.lower -> plural
        crds, rv = store.list(self.RESOURCE)
        for crd in crds:
            self._index(crd)
        self._watch = store.watch(kind=self.RESOURCE, since_rv=rv)

    def _index(self, crd: CustomResourceDefinition) -> None:
        self._by_plural[crd.names.plural] = crd
        self._by_name[crd.metadata.name] = crd
        for alias in ([crd.names.singular, crd.names.kind.lower()]
                      + list(crd.names.short_names)):
            if alias:
                self._short[alias] = crd.names.plural

    def _drop(self, crd: CustomResourceDefinition) -> None:
        self._by_plural.pop(crd.names.plural, None)
        self._by_name.pop(crd.metadata.name, None)
        self._short = {a: p for a, p in self._short.items()
                       if p != crd.names.plural}

    def _sync(self) -> None:
        if self._watch.terminated:
            # evicted as a slow watcher: relist (the reflector 410 contract)
            crds, rv = self._store.list(self.RESOURCE)
            self._by_plural.clear()
            self._by_name.clear()
            self._short.clear()
            for crd in crds:
                self._index(crd)
            self._watch = self._store.watch(kind=self.RESOURCE, since_rv=rv)
            return
        for ev in self._watch.drain():
            # MODIFIED may have renamed aliases (or the plural): drop the
            # previous index entries for this CRD before re-indexing so stale
            # shortNames/singulars stop resolving
            old = self._by_name.get(ev.obj.metadata.name)
            if old is not None:
                self._drop(old)
            if ev.type != "DELETED":
                self._index(ev.obj)

    def resolve(self, name: str) -> Optional[CustomResourceDefinition]:
        """Accepts plural, singular, kind, or a shortName."""
        with self._lock:
            self._sync()
            crd = self._by_plural.get(name)
            if crd is None and name in self._short:
                crd = self._by_plural.get(self._short[name])
            return crd

    def all(self) -> List[CustomResourceDefinition]:
        with self._lock:
            self._sync()
            return list(self._by_plural.values())


def validate_custom_object(crd: CustomResourceDefinition,
                           obj: Unstructured) -> Tuple[Optional[Unstructured], List[str]]:
    """Defaulting + pruning + validation for one write. Returns the processed
    object and errors; metadata is excluded from the schema walk (the reference
    validates it separately and never prunes it)."""
    version = crd.served_version()
    if version is None:
        return None, [f"no served version for {crd.metadata.name}"]
    if obj.api_version and obj.api_version != f"{crd.group}/{version.name}":
        # accept any declared served version, reject foreign groups
        served = {f"{crd.group}/{v.name}" for v in crd.versions if v.served}
        if obj.api_version not in served:
            return None, [f"apiVersion {obj.api_version!r} not served "
                          f"(want one of {sorted(served)})"]
    if obj.kind and obj.kind != crd.names.kind:
        return None, [f"kind {obj.kind!r} does not match CRD kind {crd.names.kind!r}"]
    if crd.scope == "Cluster":
        obj.metadata.namespace = ""  # cluster-scoped key scheme
    schema = version.schema
    if schema is None:
        return obj, []
    # schema applies to the whole object; carve metadata/apiVersion/kind out
    body = dict(obj.content)
    body = prune_and_default(schema, body)
    errs = validate_structural(schema, body)
    if errs:
        return None, errs
    processed = Unstructured(api_version=obj.api_version or f"{crd.group}/{version.name}",
                             kind=obj.kind or crd.names.kind,
                             metadata=obj.metadata, content=body)
    return processed, []

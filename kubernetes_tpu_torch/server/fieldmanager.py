"""Server-side apply: field ownership, conflict detection, merge.

The reference's canonical write path is server-side apply (SSA): every write
records which *field manager* owns which fields (`metadata.managedFields`,
FieldsV1 trie), an Apply patch merges the applied configuration into the live
object, conflicts arise when an applier changes a field owned by someone
else, `force` steals ownership, and fields a manager previously applied but
dropped from its configuration are *removed* from the object.

Reference semantics reproduced here (file:line cites into the Kubernetes source):
  - staging/src/k8s.io/apimachinery/pkg/util/managedfields/fieldmanager.go:68
    (`Update`) and :96 (`Apply`) — the two entry points below
    (`capture_update`, `apply_patch`).
  - apiserver/pkg/endpoints/handlers/patch.go:432 (`applyPatcher`) — the
    PATCH handler wiring (rest.py do_PATCH, apply-patch content type).
  - Conflict contract: structured-merge-diff merge.Update — changing a field
    owned by another manager without force => 409 listing every
    (manager, field); identical values co-own without conflict; force
    transfers ownership.
  - Removal contract: fields in a manager's previous Apply set, absent from
    the new applied configuration and co-owned by nobody else, are pruned
    from the object (merge.Update remove semantics).
  - Update (PUT/merge-PATCH) ownership: every field an update changes moves
    to the updating manager (fieldmanager.go:68 -> structured-merge-diff
    Updater.Update).

Representation: a field path is a tuple of steps — ("f", key) descends a
map field, ("k", canonical-json) selects a keyed list item, (".",) marks
item existence. A manager's field set is a frozenset of such paths; it
round-trips to the reference's FieldsV1 wire trie ({"f:spec": {"f:replicas":
{}}, "k:{\"name\":\"web\"}": {".": {}}}).

Lists whose items carry one of the reference's patch-merge keys merge
associatively (containers by name, ports by containerPort+protocol, ...);
all other lists are atomic — owned and replaced as a whole (the reference's
listType=atomic default).

The counterpart of `kubernetes_tpu/server/fieldmanager.py`: the same
behaviour, names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import json
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

Path = Tuple[Any, ...]

# patch-merge keys per field name — the reference's strategic-merge-patch
# tags / listType=map keys (api/core/v1/types.go `patchMergeKey`)
MERGE_KEYS: Dict[str, Tuple[str, ...]] = {
    "containers": ("name",),
    "initContainers": ("name",),
    "ephemeralContainers": ("name",),
    "env": ("name",),
    "volumes": ("name",),
    "volumeMounts": ("mountPath",),
    "volumeDevices": ("devicePath",),
    "ports": ("containerPort", "protocol"),
    "taints": ("key", "effect"),
    "hostAliases": ("ip",),
    "imagePullSecrets": ("name",),
    "topologySpreadConstraints": ("topologyKey", "whenUnsatisfiable"),
    "conditions": ("type",),
    "addresses": ("type",),
    "ownerReferences": ("uid",),
    "secrets": ("name",),
}

# object identity / server-managed bookkeeping is never owned or merged
# (managedfields/gvkparser + the apply strategy's reset fields)
_EXCLUDED_META = {"name", "namespace", "uid", "resourceVersion", "generation",
                  "creationTimestamp", "deletionTimestamp", "managedFields",
                  "selfLink"}
_EXCLUDED_TOP = {"apiVersion", "kind", "status"}


def _key_of(item: Dict, keys: Tuple[str, ...]) -> Optional[str]:
    """Canonical k: selector for a keyed-list item; None if keys missing."""
    if not isinstance(item, dict) or any(k not in item for k in keys):
        return None
    return json.dumps({k: item[k] for k in keys}, sort_keys=True,
                      separators=(",", ":"))


def _keyed(field: str, value: List) -> Optional[Tuple[str, ...]]:
    """Merge keys for this list field, when every item is selectable."""
    keys = MERGE_KEYS.get(field)
    if keys is None or not value:
        return keys if keys is not None and value else None
    if all(_key_of(it, keys) is not None for it in value):
        return keys
    return None


def fields_of(d: Dict, _top: bool = True) -> FrozenSet[Path]:
    """The set of field paths a wire-form object dict specifies."""
    out: List[Path] = []

    def walk(v: Any, prefix: Path, field: str) -> None:
        if isinstance(v, dict):
            if not v:
                out.append(prefix)
                return
            for k, sub in v.items():
                if prefix == () and k in _EXCLUDED_TOP:
                    continue
                if prefix == (("f", "metadata"),) and k in _EXCLUDED_META:
                    continue
                walk(sub, prefix + (("f", k),), k)
            return
        if isinstance(v, list):
            keys = _keyed(field, v)
            if keys is not None:
                for item in v:
                    sel = _key_of(item, keys)
                    item_prefix = prefix + (("k", sel),)
                    out.append(item_prefix + ((".",),))
                    for k, sub in item.items():
                        walk(sub, item_prefix + (("f", k),), k)
                return
        out.append(prefix)  # scalar or atomic list: one leaf

    walk(d, (), "")
    return frozenset(p for p in out if p)


def to_fields_v1(paths: FrozenSet[Path]) -> Dict:
    """Encode a path set as the reference's FieldsV1 trie."""
    root: Dict = {}
    for path in sorted(paths, key=lambda p: tuple(map(str, p))):
        node = root
        for step in path:
            if step == (".",):
                key = "."
            elif step[0] == "f":
                key = f"f:{step[1]}"
            else:
                key = f"k:{step[1]}"
            node = node.setdefault(key, {})
    return root


def from_fields_v1(trie: Dict) -> FrozenSet[Path]:
    out: List[Path] = []

    def walk(node: Dict, prefix: Path) -> None:
        if not node:
            if prefix:
                out.append(prefix)
            return
        for k, sub in node.items():
            if k == ".":
                out.append(prefix + ((".",),))
            elif k.startswith("f:"):
                walk(sub, prefix + (("f", k[2:]),))
            elif k.startswith("k:"):
                walk(sub, prefix + (("k", k[2:]),))

    walk(trie or {}, ())
    return frozenset(out)


def _entry(manager: str, operation: str, paths: FrozenSet[Path]) -> Dict:
    return {"manager": manager, "operation": operation,
            "fieldsType": "FieldsV1", "fieldsV1": to_fields_v1(paths)}


def _sets(managed: List[Dict]) -> List[Tuple[Dict, FrozenSet[Path]]]:
    return [(e, from_fields_v1(e.get("fieldsV1") or {})) for e in managed or []]


def _lookup(d: Dict, path: Path) -> Tuple[bool, Any]:
    """(present, value) of a field path in a wire dict."""
    node: Any = d
    for step in path:
        if step == (".",):
            return True, None
        if step[0] == "f":
            if not isinstance(node, dict) or step[1] not in node:
                return False, None
            node = node[step[1]]
        else:  # keyed item
            if not isinstance(node, list):
                return False, None
            found = None
            for item in node:
                if isinstance(item, dict):
                    sel = json.loads(step[1])
                    if all(item.get(k) == v for k, v in sel.items()):
                        found = item
                        break
            if found is None:
                return False, None
            node = found
    return True, node


class Conflict(Exception):
    """One or more applied fields are owned by other managers."""

    def __init__(self, conflicts: List[Tuple[str, Path]]):
        self.conflicts = conflicts
        msgs = [f"{path_str(p)} (owned by {m!r})" for m, p in conflicts]
        super().__init__("apply conflict: " + "; ".join(msgs))


def path_str(p: Path) -> str:
    parts = []
    for step in p:
        if step == (".",):
            continue
        parts.append(step[1] if step[0] == "f" else f"[{step[1]}]")
    return ".".join(parts)


def _merge(live: Any, applied: Any, field: str) -> Any:
    """Structural merge of the applied config into the live value."""
    if isinstance(applied, dict) and isinstance(live, dict):
        out = dict(live)
        for k, v in applied.items():
            out[k] = _merge(live.get(k), v, k) if k in live else v
        return out
    if isinstance(applied, list) and isinstance(live, list):
        keys = _keyed(field, applied)
        if keys is not None and _keyed(field, live) is not None:
            # associative merge: update matching items in live order,
            # append new items in applied order (structured-merge-diff
            # keeps the live relative order for existing keys)
            applied_by_key = {_key_of(it, keys): it for it in applied}
            out = []
            for item in live:
                sel = _key_of(item, keys)
                if sel in applied_by_key:
                    out.append(_merge(item, applied_by_key.pop(sel), field))
                else:
                    out.append(item)
            out.extend(applied_by_key.values())
            return out
    return applied  # scalars and atomic lists replace


def _remove_path(d: Dict, path: Path) -> None:
    """Delete a leaf path from a wire dict, pruning emptied parents."""
    parents: List[Tuple[Any, Any]] = []  # (container, key/selector)
    node: Any = d
    for step in path:
        if step == (".",):
            break
        if step[0] == "f":
            if not isinstance(node, dict) or step[1] not in node:
                return
            parents.append((node, step[1]))
            node = node[step[1]]
        else:
            if not isinstance(node, list):
                return
            sel = json.loads(step[1])
            idx = next((i for i, it in enumerate(node)
                        if isinstance(it, dict)
                        and all(it.get(k) == v for k, v in sel.items())), None)
            if idx is None:
                return
            parents.append((node, idx))
            node = node[idx]
    if not parents:
        return
    if path[-1] == (".",):
        # item-existence removal: drop the whole list item
        container, key = parents[-1]
        if isinstance(container, list):
            del container[key]
        else:
            container.pop(key, None)
    else:
        container, key = parents[-1]
        if isinstance(container, dict):
            container.pop(key, None)
        elif isinstance(container, list) and isinstance(key, int):
            del container[key]
    # prune parents that became empty (a dict the manager emptied out should
    # not linger as {}), but never the object root
    for container, key in reversed(parents[:-1]):
        child = container[key] if (isinstance(container, dict)
                                   and key in container) else None
        if child in ({}, []):
            if isinstance(container, dict):
                container.pop(key, None)


def apply_patch(live: Optional[Dict], applied: Dict, manager: str,
                force: bool = False) -> Dict:
    """SSA Apply: merge `applied` into `live`, enforce ownership, update
    managedFields. Returns the merged wire dict; raises Conflict.

    live=None is the create path: the applier owns everything it sent.
    Mirrors managedfields/fieldmanager.go:96 + structured-merge-diff
    merge.Update."""
    applied = json.loads(json.dumps(applied))  # defensive deep copy
    applied_set = fields_of(applied)
    if live is None:
        merged = applied
        merged.setdefault("metadata", {})["managedFields"] = [
            _entry(manager, "Apply", applied_set)]
        return merged

    managed = list((live.get("metadata") or {}).get("managedFields") or [])
    own_prev: FrozenSet[Path] = frozenset()
    self_updates: List[Tuple[Dict, FrozenSet[Path]]] = []
    others: List[Tuple[Dict, FrozenSet[Path]]] = []
    for e, s in _sets(managed):
        if e.get("manager") == manager and e.get("operation") == "Apply":
            own_prev = s
        elif e.get("manager") == manager:
            # same manager name via POST/PUT/merge-PATCH: no conflict — an
            # applier silently takes over fields it owned through updates
            # (the reference's documented update->apply takeover); fields it
            # does NOT apply stay in the Update entry (not pruned)
            self_updates.append((e, s))
        else:
            others.append((e, s))

    # conflicts: applied field differs from live AND another manager owns it
    conflicts: List[Tuple[str, Path]] = []
    changing: List[Path] = []
    for p in applied_set:
        present, live_v = _lookup(live, p)
        _, applied_v = _lookup(applied, p)
        if not present or live_v != applied_v:
            changing.append(p)
    for e, s in others:
        hit = s.intersection(changing)
        for p in sorted(hit, key=lambda p: tuple(map(str, p))):
            conflicts.append((e.get("manager", "unknown"), p))
    if conflicts and not force:
        raise Conflict(conflicts)

    merged = _merge(json.loads(json.dumps(live)), applied, "")

    # removal: fields this manager applied before, dropped now, owned by
    # nobody else (incl. its own Update entries)
    foreign: FrozenSet[Path] = frozenset().union(
        *[s for _, s in others + self_updates]) \
        if others or self_updates else frozenset()
    for p in sorted(own_prev - applied_set - foreign,
                    key=lambda p: (-len(p), tuple(map(str, p)))):
        if p[-1] == (".",):
            # a keyed item survives while ANY other entry owns a field
            # inside it (structured-merge-diff keeps items with foreign
            # descendants; only this manager's own fields get pruned)
            prefix = p[:-1]
            if any(q[:len(prefix)] == prefix for q in foreign):
                continue
        if len(p) >= 2 and p[-2][0] == "k" and p[-1][0] == "f" \
                and p[-1][1] in json.loads(p[-2][1]):
            # merge-key fields are the item's identity: they go only when
            # the whole item goes (the "." removal above sorts first)
            continue
        _remove_path(merged, p)

    # new managedFields: this manager's Apply entry is exactly applied_set;
    # forced conflicts move ownership away from the losers; applied fields
    # leave the manager's own Update entries (takeover)
    stolen = frozenset(p for _, p in conflicts)
    new_managed: List[Dict] = []
    for e, s in others:
        remaining = s - stolen
        if remaining:
            new_managed.append(_entry(e.get("manager", "unknown"),
                                      e.get("operation", "Update"), remaining))
    for e, s in self_updates:
        remaining = s - applied_set
        if remaining:
            new_managed.append(_entry(manager,
                                      e.get("operation", "Update"), remaining))
    new_managed.append(_entry(manager, "Apply", applied_set))
    merged.setdefault("metadata", {})["managedFields"] = new_managed
    return merged


def capture_update(before: Optional[Dict], after: Dict,
                   manager: str) -> List[Dict]:
    """Non-apply write (POST/PUT/merge-PATCH): every field the write changed
    moves to `manager` (operation Update); fields the write removed leave all
    managers. Returns the new managedFields list (fieldmanager.go:68).
    Status-subresource writes are not tracked (status is excluded from apply
    ownership outright — _EXCLUDED_TOP)."""
    after_set = fields_of(after)
    if before is None:
        return [_entry(manager, "Update", after_set)]
    managed = list((before.get("metadata") or {}).get("managedFields") or [])
    changed: List[Path] = []
    for p in after_set:
        present, before_v = _lookup(before, p)
        _, after_v = _lookup(after, p)
        if not present or before_v != after_v:
            changed.append(p)
    changed_set = frozenset(changed)
    removed = frozenset(p for p in fields_of(before)
                        if not _lookup(after, p)[0])

    new_managed: List[Dict] = []
    own: FrozenSet[Path] = frozenset()
    for e, s in _sets(managed):
        if e.get("manager") == manager and e.get("operation") == "Update":
            own = s
            continue
        remaining = s - changed_set - removed
        if remaining:
            new_managed.append(_entry(e.get("manager", "unknown"),
                                      e.get("operation", "Update"), remaining))
    mine = (own - removed) | changed_set
    if mine:
        new_managed.append(_entry(manager, "Update", mine))
    return new_managed

"""Label selectors and node-selector terms.

Re-provides the matching semantics of k8s labels.Selector
(reference: staging/src/k8s.io/apimachinery/pkg/labels/selector.go) and
NodeSelector/NodeSelectorTerm matching
(reference: staging/src/k8s.io/component-helpers/scheduling/corev1/nodeaffinity/nodeaffinity.go).

Key semantic points preserved:
  - A LabelSelector of `None` matches nothing; an empty selector matches everything.
  - NotIn / DoesNotExist match when the key is absent.
  - Gt/Lt parse the node label value as an integer; absent or non-integer => no match.
  - NodeSelector is an OR of terms; each term is an AND of requirements; an empty
    term list matches nothing, a term with no requirements matches nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

_OPS = {IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT}


@dataclass(frozen=True)
class Requirement:
    key: str
    op: str
    values: Tuple[str, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        if self.op == IN:
            return has and labels[self.key] in self.values
        if self.op == NOT_IN:
            return (not has) or labels[self.key] not in self.values
        if self.op == EXISTS:
            return has
        if self.op == DOES_NOT_EXIST:
            return not has
        if self.op in (GT, LT):
            if not has or len(self.values) != 1:
                return False
            try:
                lhs = int(labels[self.key])
                rhs = int(self.values[0])
            except ValueError:
                return False
            return lhs > rhs if self.op == GT else lhs < rhs
        raise ValueError(f"unknown operator {self.op!r}")


@dataclass(frozen=True)
class Selector:
    """AND of requirements. Empty selector matches everything."""

    requirements: Tuple[Requirement, ...] = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        return all(r.matches(labels) for r in self.requirements)

    def is_empty(self) -> bool:
        return not self.requirements

    @staticmethod
    def from_match_labels(match_labels: Mapping[str, str]) -> "Selector":
        return Selector(
            tuple(Requirement(k, IN, (v,)) for k, v in sorted(match_labels.items()))
        )

    @staticmethod
    def from_label_selector(sel: Optional[Mapping]) -> Optional["Selector"]:
        """Convert a k8s LabelSelector dict ({matchLabels, matchExpressions}).

        Returns None for a nil selector (matches nothing — callers must check),
        mirroring metav1.LabelSelectorAsSelector.
        """
        if sel is None:
            return None
        reqs: List[Requirement] = []
        for k, v in sorted((sel.get("matchLabels") or {}).items()):
            reqs.append(Requirement(k, IN, (v,)))
        for e in sel.get("matchExpressions") or []:
            reqs.append(parse_requirement(e))
        return Selector(tuple(reqs))


def parse_requirement(e: Mapping) -> Requirement:
    """Parse and validate one {key, operator, values} expression."""
    op = e["operator"]
    if op not in _OPS:
        raise ValueError(f"unknown selector operator {op!r}")
    return Requirement(e["key"], op, tuple(e.get("values") or ()))


@dataclass(frozen=True)
class NodeSelectorTerm:
    """AND of matchExpressions (on labels) + matchFields (on metadata.name)."""

    match_expressions: Tuple[Requirement, ...] = ()
    match_fields: Tuple[Requirement, ...] = ()

    def matches(self, node) -> bool:
        if not self.match_expressions and not self.match_fields:
            return False  # empty term matches nothing (nodeaffinity.go)
        if not all(r.matches(node.metadata.labels) for r in self.match_expressions):
            return False
        fields = {"metadata.name": node.metadata.name}
        return all(r.matches(fields) for r in self.match_fields)


@dataclass(frozen=True)
class NodeSelector:
    """OR of terms. Empty selector (no terms) matches nothing."""

    terms: Tuple[NodeSelectorTerm, ...] = ()

    def matches(self, node) -> bool:
        return any(t.matches(node) for t in self.terms)

    @staticmethod
    def from_dict(d: Optional[Mapping]) -> Optional["NodeSelector"]:
        if d is None:
            return None
        terms = []
        for t in d.get("nodeSelectorTerms") or []:
            terms.append(
                NodeSelectorTerm(
                    tuple(parse_requirement(e) for e in t.get("matchExpressions") or []),
                    tuple(parse_requirement(e) for e in t.get("matchFields") or []),
                )
            )
        return NodeSelector(tuple(terms))


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    term: NodeSelectorTerm

    @staticmethod
    def from_dict(d: Mapping) -> "PreferredSchedulingTerm":
        p = d["preference"]
        return PreferredSchedulingTerm(
            weight=int(d["weight"]),
            term=NodeSelectorTerm(
                tuple(parse_requirement(e) for e in p.get("matchExpressions") or []),
                tuple(parse_requirement(e) for e in p.get("matchFields") or []),
            ),
        )


def parse_selector_string(raw: str) -> Selector:
    """Parse the label-selector QUERY STRING grammar
    (apimachinery/pkg/labels/selector.go Parse): comma-joined requirements of
    the forms `k=v`, `k==v`, `k!=v`, `k in (a,b)`, `k notin (a,b)`, `k`,
    `!k`. Raises ValueError on malformed input (the apiserver's 400)."""
    import re

    reqs: List[Requirement] = []
    raw = raw.strip()
    # split on commas NOT inside parentheses
    parts: List[str] = []
    depth = 0
    start = 0
    for i, ch in enumerate(raw):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(raw[start:i])
            start = i + 1
    parts.append(raw[start:])
    set_re = re.compile(r"^(?P<key>[^!=\s]+)\s+(?P<op>in|notin)\s*"
                        r"\((?P<vals>[^)]*)\)$")
    key_re = re.compile(r"^[A-Za-z0-9._/-]+$")

    def checked_key(k: str, part: str) -> str:
        k = k.strip()
        if not key_re.match(k):
            raise ValueError(f"invalid label key in clause {part!r}")
        return k

    for part in parts:
        part = part.strip()
        if not part:
            continue
        m = set_re.match(part)
        if m:
            vals = tuple(v.strip() for v in m.group("vals").split(",")
                         if v.strip())
            if not vals:
                raise ValueError(f"empty value set in {part!r}")
            reqs.append(Requirement(checked_key(m.group("key"), part),
                                    IN if m.group("op") == "in" else NOT_IN,
                                    vals))
        elif "!=" in part:
            k, _, v = part.partition("!=")
            reqs.append(Requirement(checked_key(k, part), NOT_IN, (v.strip(),)))
        elif "=" in part:
            k, _, v = part.partition("=")
            if v.startswith("="):  # the == alias
                v = v[1:]
            reqs.append(Requirement(checked_key(k, part), IN, (v.strip(),)))
        elif part.startswith("!"):
            reqs.append(Requirement(checked_key(part[1:], part), DOES_NOT_EXIST))
        elif key_re.match(part):
            reqs.append(Requirement(part, EXISTS))
        else:
            raise ValueError(f"unparsable selector clause {part!r}")
    return Selector(tuple(reqs))

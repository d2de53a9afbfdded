"""The runtime lock-graph witness of the store's ordered locks.

The counterpart of `kubernetes_tpu/store/lockgraph.py`. `_OrderedRLock`
(store/store.py, armed by APIStore(lock_order_check=True), env
STORE_LOCK_ORDER_CHECK=1 and every store built under pytest) asserts the
ordering table on every acquisition; this module makes a run a WITNESS:
every fresh acquisition made while another ordered lock is held records the
edge (held -> acquired) here, with the acquisition stack captured on the
edge's FIRST sighting only (one dict hit after that). diff() holds the
recorded edge set against the ordering table:

  * an edge between two ranked locks that is not strictly ascending in
    rank is an inversion, reported with BOTH stacks (the first-seen stack
    of the offending edge and of its reverse, when witnessed);
  * any cycle in the witnessed graph (ranked or not) is a latent deadlock,
    reported with the first-seen stack of every edge on the cycle;
  * edges between unranked (scratch/test) locks are informational.

The port's WITNESS is its own object, apart from the JAX package's: the
port's tests gate on it (tests/test_torch_lockgraph.py), render() prints
the graph and export() writes it as JSON.
"""

from __future__ import annotations

import json
import threading
import traceback
from typing import Dict, List, Optional, Tuple

# The ordering table (must match the _OrderedRLock names built in
# store/store.py APIStore.__init__): rank strictly ascends along every
# legal acquisition edge.
ORDER_TABLE: Dict[str, int] = {
    "_lock (global RV)": 0,
    "_pods_lock (pods shard)": 1,
    "_nodes_lock (nodes shard)": 2,
}

_STACK_LIMIT = 16


class LockGraphWitness:
    """Edge-set recorder for ordered-lock acquisitions.

    record() is called with the lock the thread already holds (top of its
    per-store stack) and the lock being acquired. The hot path is a plain
    dict membership check — the stack capture (the expensive part) happens
    only the first time an edge is seen. Counts are best-effort under the
    GIL (a lost increment never loses the EDGE)."""

    def __init__(self):
        self._mu = threading.Lock()
        # (held_name, acq_name) -> edge record
        self.edges: Dict[Tuple[str, str], Dict] = {}

    def record(self, held_name: str, held_rank: int,
               acq_name: str, acq_rank: int) -> None:
        key = (held_name, acq_name)
        e = self.edges.get(key)
        if e is not None:
            e["count"] += 1
            return
        stack = "".join(traceback.format_stack(limit=_STACK_LIMIT)[:-1])
        with self._mu:
            if key not in self.edges:
                self.edges[key] = {
                    "held": held_name, "held_rank": held_rank,
                    "acquired": acq_name, "acquired_rank": acq_rank,
                    "count": 1, "first_stack": stack,
                }
            else:
                self.edges[key]["count"] += 1

    def clear(self) -> None:
        with self._mu:
            self.edges.clear()

    # -- the diff --------------------------------------------------------------

    def diff(self, table: Optional[Dict[str, int]] = None) -> Dict:
        """Diff the witnessed edge set against the ordering table."""
        table = ORDER_TABLE if table is None else table
        edges = dict(self.edges)
        violations: List[Dict] = []
        for (held, acq), e in edges.items():
            hr, ar = table.get(held), table.get(acq)
            if hr is None or ar is None:
                continue
            if ar <= hr:
                rev = edges.get((acq, held))
                violations.append({
                    "edge": f"{held} -> {acq}",
                    "why": f"rank {hr} -> {ar} is not ascending "
                           f"(the store's ordering table)",
                    "stack": e["first_stack"],
                    "reverse_stack": rev["first_stack"] if rev else None,
                })
        cycles = self._cycles(edges)
        unknown = sorted(
            f"{held} -> {acq}" for (held, acq) in edges
            if held not in table or acq not in table)
        return {
            "edges": len(edges),
            "acquisitions": sum(e["count"] for e in edges.values()),
            "violations": violations,
            "cycles": cycles,
            "unknown_edges": unknown,
            "clean": not violations and not cycles,
        }

    def _cycles(self, edges: Dict[Tuple[str, str], Dict]) -> List[Dict]:
        graph: Dict[str, List[str]] = {}
        for held, acq in edges:
            graph.setdefault(held, []).append(acq)
        out: List[Dict] = []
        seen_cycles = set()
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in graph}

        def visit(node: str, path: List[str]) -> None:
            color[node] = GREY
            for nxt in graph.get(node, ()):
                if color.get(nxt, WHITE) == GREY:
                    i = path.index(nxt)
                    cyc = path[i:] + [nxt]
                    key = frozenset(zip(cyc, cyc[1:]))
                    if key in seen_cycles:
                        continue
                    seen_cycles.add(key)
                    out.append({
                        "cycle": " -> ".join(cyc),
                        "stacks": {
                            f"{a} -> {b}":
                                edges[(a, b)]["first_stack"]
                            for a, b in zip(cyc, cyc[1:])
                            if (a, b) in edges},
                    })
                elif color.get(nxt, WHITE) == WHITE:
                    visit(nxt, path + [nxt])
            color[node] = BLACK

        for n in list(graph):
            if color[n] == WHITE:
                visit(n, [n])
        return out

    # -- rendering / export ----------------------------------------------------

    def as_dict(self, table: Optional[Dict[str, int]] = None) -> Dict:
        return {
            "order_table": ORDER_TABLE if table is None else table,
            "edges": [dict(e) for e in self.edges.values()],
            "diff": self.diff(table),
        }

    def export(self, path: str,
               table: Optional[Dict[str, int]] = None) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.as_dict(table), f, indent=2)

    def render(self, table: Optional[Dict[str, int]] = None) -> str:
        table = ORDER_TABLE if table is None else table
        report = self.diff(table)
        lines = ["lock-graph witness (held -> acquired, runtime edges):"]
        for (held, acq), e in sorted(self.edges.items()):
            hr = table.get(held, "?")
            ar = table.get(acq, "?")
            lines.append(f"  {held} [rank {hr}] -> {acq} [rank {ar}]  "
                         f"x{e['count']}")
        if not self.edges:
            lines.append("  (no multi-lock acquisitions witnessed)")
        for v in report["violations"]:
            lines.append(f"INVERSION: {v['edge']} — {v['why']}")
            lines.append("  first acquisition stack:")
            lines.extend("    " + ln for ln in v["stack"].splitlines())
            if v["reverse_stack"]:
                lines.append("  reverse edge's first stack:")
                lines.extend("    " + ln
                             for ln in v["reverse_stack"].splitlines())
        for c in report["cycles"]:
            lines.append(f"CYCLE: {c['cycle']}")
            for edge, stack in c["stacks"].items():
                lines.append(f"  {edge} first acquisition stack:")
                lines.extend("    " + ln for ln in stack.splitlines())
        lines.append(
            f"witness: {report['edges']} distinct edge(s), "
            f"{report['acquisitions']} lock-held acquisitions, "
            f"{len(report['violations'])} inversion(s), "
            f"{len(report['cycles'])} cycle(s)"
            + (" — CLEAN against the ordering table"
               if report["clean"] else ""))
        return "\n".join(lines)


# the process-wide witness every lock-order-checked store of the port records
# into (tests that seed deliberate inversions build their own instance)
WITNESS = LockGraphWitness()

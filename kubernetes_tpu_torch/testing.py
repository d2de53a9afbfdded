"""Fluent MakePod/MakeNode constructors for tests and the chip smoke
(reference: pkg/scheduler/testing/wrappers.go st.MakePod()/MakeNode()), the
PodGroup constructor, the pod-conservation check, a seeded [G, N]
transportation problem for the transport kernels' checks (with a warm start
that overfills nodes, and a test-only numpy model of kernel E's round that
accepts only where bids landed), seeded and
edge-case defrag-assignment problems for kernel I's (and runs of identical
requests), seeded greedy-scan problems for kernel A's, seeded mirror churn
for kernel B's, a seeded fallback-class workload (volumes, DRA, spread
inclusion policies beside plain pods: fallback_workload), and test-only numpy models of kernel C's selection over
sorted key rows, kernel G's victim-parallel curve, kernel I's tournament
tree and kernel J's tiled maxima. The same API as
`kubernetes_tpu/testing.py`, so one workload generator can create the same
objects for both packages."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from .api import (
    Affinity,
    Container,
    ContainerImage,
    ContainerPort,
    Node,
    NodeSelector,
    ObjectMeta,
    Pod,
    PodAffinityTerm,
    PreferredSchedulingTerm,
    Selector,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
    new_uid,
)


class MakePod:
    def __init__(self, name: str = "p", namespace: str = "default"):
        self._pod = Pod(metadata=ObjectMeta(name=name, namespace=namespace, uid=new_uid()))

    def name(self, n: str) -> "MakePod":
        self._pod.metadata.name = n
        return self

    def namespace(self, ns: str) -> "MakePod":
        self._pod.metadata.namespace = ns
        return self

    def uid(self, uid: str) -> "MakePod":
        self._pod.metadata.uid = uid
        return self

    def labels(self, labels: Dict[str, str]) -> "MakePod":
        self._pod.metadata.labels.update(labels)
        return self

    def gang(self, group_name: str, rank: Optional[int] = None) -> "MakePod":
        """Join the PodGroup `group_name` (in the pod's namespace); `rank` adds
        the positional rank label the rank-alignment pass consumes."""
        from .api.podgroup import POD_GROUP_LABEL, POD_GROUP_RANK_LABEL

        self._pod.metadata.labels[POD_GROUP_LABEL] = group_name
        if rank is not None:
            self._pod.metadata.labels[POD_GROUP_RANK_LABEL] = str(rank)
        return self

    def req(self, requests: Dict[str, str], image: str = "", host_port: int = 0) -> "MakePod":
        """Add a container with the given resource requests."""
        c = Container(
            name=f"c{len(self._pod.spec.containers)}",
            image=image,
            resources={"requests": dict(requests)} if requests else {},
        )
        if host_port:
            c.ports.append(ContainerPort(container_port=host_port, host_port=host_port))
        self._pod.spec.containers.append(c)
        return self

    def init_req(self, requests: Dict[str, str]) -> "MakePod":
        self._pod.spec.init_containers.append(
            Container(name=f"i{len(self._pod.spec.init_containers)}",
                      resources={"requests": dict(requests)})
        )
        return self

    def container(self, image: str) -> "MakePod":
        self._pod.spec.containers.append(
            Container(name=f"c{len(self._pod.spec.containers)}", image=image)
        )
        return self

    def node(self, node_name: str) -> "MakePod":
        self._pod.spec.node_name = node_name
        return self

    def node_selector(self, sel: Dict[str, str]) -> "MakePod":
        self._pod.spec.node_selector.update(sel)
        return self

    def node_affinity_in(self, key: str, values) -> "MakePod":
        self._affinity().node_affinity_required = NodeSelector.from_dict(
            {"nodeSelectorTerms": [{"matchExpressions": [
                {"key": key, "operator": "In", "values": list(values)}]}]}
        )
        return self

    def preferred_node_affinity(self, weight: int, key: str, values) -> "MakePod":
        self._affinity().node_affinity_preferred.append(
            PreferredSchedulingTerm.from_dict({
                "weight": weight,
                "preference": {"matchExpressions": [
                    {"key": key, "operator": "In", "values": list(values)}]},
            })
        )
        return self

    def pod_affinity(self, topology_key: str, match_labels: Dict[str, str]) -> "MakePod":
        self._affinity().pod_affinity_required.append(
            PodAffinityTerm(topology_key=topology_key,
                            selector=Selector.from_match_labels(match_labels))
        )
        return self

    def pod_anti_affinity(self, topology_key: str, match_labels: Dict[str, str]) -> "MakePod":
        self._affinity().pod_anti_affinity_required.append(
            PodAffinityTerm(topology_key=topology_key,
                            selector=Selector.from_match_labels(match_labels))
        )
        return self

    def preferred_pod_affinity(self, weight: int, topology_key: str, match_labels: Dict[str, str]) -> "MakePod":
        self._affinity().pod_affinity_preferred.append(
            WeightedPodAffinityTerm(weight, PodAffinityTerm(
                topology_key=topology_key, selector=Selector.from_match_labels(match_labels)))
        )
        return self

    def preferred_pod_anti_affinity(self, weight: int, topology_key: str, match_labels: Dict[str, str]) -> "MakePod":
        self._affinity().pod_anti_affinity_preferred.append(
            WeightedPodAffinityTerm(weight, PodAffinityTerm(
                topology_key=topology_key, selector=Selector.from_match_labels(match_labels)))
        )
        return self

    def toleration(self, key: str, value: str = "", operator: str = "Equal", effect: str = "") -> "MakePod":
        self._pod.spec.tolerations.append(
            Toleration(key=key, operator=operator, value=value, effect=effect)
        )
        return self

    def topology_spread(self, max_skew: int, topology_key: str, when: str,
                        match_labels: Optional[Dict[str, str]] = None,
                        min_domains: Optional[int] = None) -> "MakePod":
        self._pod.spec.topology_spread_constraints.append(
            TopologySpreadConstraint(
                max_skew=max_skew, topology_key=topology_key, when_unsatisfiable=when,
                selector=Selector.from_match_labels(match_labels or {}),
                min_domains=min_domains,
            )
        )
        return self

    def priority(self, p: int) -> "MakePod":
        self._pod.spec.priority = p
        return self

    def claim(self, claim_name: str, ref_name: str = "") -> "MakePod":
        """Reference a DRA ResourceClaim (PodSpec.resourceClaims)."""
        self._pod.spec.resource_claims.append(
            (ref_name or claim_name, claim_name))
        return self

    def scheduling_gate(self, name: str) -> "MakePod":
        self._pod.spec.scheduling_gates.append(name)
        return self

    def phase(self, phase: str) -> "MakePod":
        self._pod.status.phase = phase
        return self

    def pvc(self, claim_name: str, read_only: bool = False) -> "MakePod":
        self._pod.spec.volumes.append(
            Volume(name=f"vol-{len(self._pod.spec.volumes)}", pvc_claim_name=claim_name,
                   pvc_read_only=read_only))
        return self

    def volume(self, **kwargs) -> "MakePod":
        kwargs.setdefault("name", f"vol-{len(self._pod.spec.volumes)}")
        self._pod.spec.volumes.append(Volume(**kwargs))
        return self

    def _affinity(self) -> Affinity:
        if self._pod.spec.affinity is None:
            self._pod.spec.affinity = Affinity()
        return self._pod.spec.affinity

    def obj(self) -> Pod:
        return self._pod


class MakeNode:
    def __init__(self, name: str = "n"):
        self._node = Node(metadata=ObjectMeta(name=name, namespace="", uid=new_uid()))
        self._node.metadata.labels["kubernetes.io/hostname"] = name

    def name(self, n: str) -> "MakeNode":
        self._node.metadata.name = n
        self._node.metadata.labels["kubernetes.io/hostname"] = n
        return self

    def labels(self, labels: Dict[str, str]) -> "MakeNode":
        self._node.metadata.labels.update(labels)
        return self

    def tpu_slice(self, slice_id, index: Optional[int] = None) -> "MakeNode":
        """Advertise the node's TPU slice (interconnect domain); `index` adds
        the optional ring-position label."""
        from .api.podgroup import LABEL_TPU_SLICE, LABEL_TPU_SLICE_INDEX

        self._node.metadata.labels[LABEL_TPU_SLICE] = str(slice_id)
        if index is not None:
            self._node.metadata.labels[LABEL_TPU_SLICE_INDEX] = str(index)
        return self

    def capacity(self, cap: Dict[str, str]) -> "MakeNode":
        cap = dict(cap)
        cap.setdefault("pods", "110")
        self._node.status.capacity = cap
        self._node.status.allocatable = dict(cap)
        return self

    def taints(self, taints) -> "MakeNode":
        self._node.spec.taints = [
            t if isinstance(t, Taint) else Taint.from_dict(t) for t in taints
        ]
        return self

    def unschedulable(self, v: bool = True) -> "MakeNode":
        self._node.spec.unschedulable = v
        return self

    def images(self, images: Dict[str, int]) -> "MakeNode":
        self._node.status.images = [
            ContainerImage(names=(name,), size_bytes=size) for name, size in images.items()
        ]
        return self

    def obj(self) -> Node:
        return self._node


FALLBACK_DRIVER = "csi.example.com"
FALLBACK_DEVICE_CLASS = "gpu.example.com"


def fallback_api():
    """The modules fallback_workload builds from: this package's. A test
    passes the same namespace of the JAX package's to build identical
    objects there."""
    from .api import dra, storage

    return SimpleNamespace(MakeNode=MakeNode, MakePod=MakePod, ObjectMeta=ObjectMeta,
                           NodeSelector=NodeSelector, storage=storage, dra=dra)


def fallback_workload(seed, n_nodes, n_device, zones=10, tainted=0, slice_every=10,
                      devices_per_slice=8, csi_limit=3, prebound=48, provision=16,
                      static=8, dra_one=32, dra_two=16, spread=16, ephemeral=0,
                      shared_disk=0, api=None):
    """Objects of a batch that mixes device pods with every fallback class,
    in creation order: {kind: [objects]} for nodes, csinodes,
    storageclasses, persistentvolumes, persistentvolumeclaims,
    deviceclasses, resourceslices, resourceclaims and pods, plus "class_of"
    (pod name -> its class). The shape follows scheduler_perf's volume and
    DRA suites (test/integration/scheduler_perf/): nodes of 8 cpu / 32Gi /
    110 pods, node i in zone z{i % zones}, `tainted` of them NoSchedule, a
    CSINode a node with an attach limit for FALLBACK_DRIVER; a
    WaitForFirstConsumer class "wfc" that provisions in the first half of
    the zones and one, "local", for static PVs; one DeviceClass and a
    ResourceSlice of `devices_per_slice` devices on every `slice_every`-th
    node. Pods, all 500m/1Gi: `n_device` plain ones and, spread through them
    by a default_rng(seed) permutation, `prebound` with a bound PVC whose PV
    has zone affinity and a CSI source, `provision` WaitForFirstConsumer
    pods provisioned through "wfc", `static` matched to as many static PVs,
    `dra_one` / `dra_two` with a ResourceClaim of one / two devices,
    `spread` with a zone spread (maxSkew 1, nodeTaintsPolicy Honor),
    `ephemeral` with an ephemeral volume and `shared_disk` pairs sharing a
    GCE disk."""
    a = api or fallback_api()
    st, dra = a.storage, a.dra
    rng = np.random.default_rng(seed)
    zone = "topology.kubernetes.io/zone"
    out = {k: [] for k in ("nodes", "csinodes", "storageclasses", "persistentvolumes",
                           "persistentvolumeclaims", "deviceclasses", "resourceslices",
                           "resourceclaims", "pods")}
    stride = n_nodes // tainted if tainted else 0
    for i in range(n_nodes):
        b = a.MakeNode(f"node-{i}").labels({zone: f"z{i % zones}"}).capacity(
            {"cpu": "8", "memory": "32Gi", "pods": "110"})
        if stride and i % stride == stride - 1:
            b = b.taints([{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}])
        out["nodes"].append(b.obj())
        out["csinodes"].append(st.CSINode(metadata=a.ObjectMeta(name=f"node-{i}"),
                                          drivers={FALLBACK_DRIVER: csi_limit}))

    def zones_in(values):
        return a.NodeSelector.from_dict({"nodeSelectorTerms": [{"matchExpressions": [
            {"key": zone, "operator": "In", "values": list(values)}]}]})

    wfc = st.StorageClass(metadata=a.ObjectMeta(name="wfc"), provisioner=FALLBACK_DRIVER,
                          volume_binding_mode=st.BINDING_WAIT_FOR_FIRST_CONSUMER,
                          allowed_topologies=zones_in(f"z{z}" for z in range(max(zones // 2, 1))))
    local = st.StorageClass(metadata=a.ObjectMeta(name="local"),
                            volume_binding_mode=st.BINDING_WAIT_FOR_FIRST_CONSUMER)
    out["storageclasses"] += [wfc, local]

    def pvc(name, sc, volume=""):
        c = st.PersistentVolumeClaim(metadata=a.ObjectMeta(name=name))
        c.spec.access_modes = [st.READ_WRITE_ONCE]
        c.spec.request = 10 * 2**30
        c.spec.storage_class_name = sc
        if volume:
            c.spec.volume_name = volume
            c.phase = st.CLAIM_BOUND
        return c

    def pv(name, z, claim=""):
        v = st.PersistentVolume(metadata=a.ObjectMeta(name=name))
        v.spec.capacity = 20 * 2**30
        v.spec.access_modes = [st.READ_WRITE_ONCE]
        v.spec.storage_class_name = "local"
        v.spec.node_affinity = zones_in([z])
        v.spec.csi_driver = FALLBACK_DRIVER
        v.spec.volume_handle = f"handle-{name}"
        if claim:
            v.spec.claim_ref = f"default/{claim}"
            v.phase = st.VOLUME_BOUND
        return v

    fallback = []  # (name, class, builder)
    for j in range(prebound):
        out["persistentvolumes"].append(pv(f"pv-bound-{j}", f"z{j % zones}", f"data-{j}"))
        out["persistentvolumeclaims"].append(pvc(f"data-{j}", "local", f"pv-bound-{j}"))
        fallback.append((f"fb-prebound-{j}", "prebound", lambda b, j=j: b.pvc(f"data-{j}")))
    for j in range(provision):
        out["persistentvolumeclaims"].append(pvc(f"prov-{j}", "wfc"))
        fallback.append((f"fb-provision-{j}", "provision", lambda b, j=j: b.pvc(f"prov-{j}")))
    for j in range(static):
        out["persistentvolumes"].append(pv(f"pv-static-{j}", f"z{(3 * j + 1) % zones}"))
        out["persistentvolumeclaims"].append(pvc(f"static-{j}", "local"))
        fallback.append((f"fb-static-{j}", "static", lambda b, j=j: b.pvc(f"static-{j}")))
    for j in range(ephemeral):
        out["persistentvolumeclaims"].append(pvc(f"fb-ephemeral-{j}-scratch", "wfc"))
        fallback.append((f"fb-ephemeral-{j}", "ephemeral",
                         lambda b: b.volume(name="scratch", ephemeral=True)))
    for j in range(shared_disk):
        for side in range(2):
            fallback.append((f"fb-disk-{j}-{side}", "shared_disk",
                             lambda b, j=j: b.volume(gce_pd=f"disk-{j}")))
    if dra_one or dra_two:
        out["deviceclasses"].append(dra.DeviceClass(
            metadata=a.ObjectMeta(name=FALLBACK_DEVICE_CLASS, namespace=""),
            selectors=[dra.DeviceAttributeRequirement(key="type", op="==", value="gpu")]))
        for i in range(0, n_nodes, slice_every):
            out["resourceslices"].append(dra.ResourceSlice(
                metadata=a.ObjectMeta(name=f"node-{i}-gpus", namespace=""), node_name=f"node-{i}",
                driver=FALLBACK_DEVICE_CLASS, pool=f"node-{i}",
                devices=[dra.Device(name=f"gpu-{d}", attributes={"type": "gpu", "memGiB": 80})
                         for d in range(devices_per_slice)]))
    for j in range(dra_one + dra_two):
        count = 1 if j < dra_one else 2
        out["resourceclaims"].append(dra.ResourceClaim(
            metadata=a.ObjectMeta(name=f"claim-{j}"),
            requests=[dra.DeviceRequest(name="gpu", device_class_name=FALLBACK_DEVICE_CLASS,
                                        count=count)]))
        fallback.append((f"fb-dra{count}-{j}", f"dra{count}", lambda b, j=j: b.claim(f"claim-{j}")))

    def spread_pod(b):
        b = b.labels({"app": "fb-spread"}).topology_spread(1, zone, "DoNotSchedule",
                                                           {"app": "fb-spread"})
        pod = b.obj()
        c = pod.spec.topology_spread_constraints[0]
        pod.spec.topology_spread_constraints = [type(c)(**{**vars(c),
                                                            "node_taints_policy": "Honor"})]
        return pod

    for j in range(spread):
        fallback.append((f"fb-spread-{j}", "spread", spread_pod))
    names = [f"pod-{i}" for i in range(n_device)] + [f[0] for f in fallback]
    build = {f[0]: f[2] for f in fallback}
    out["class_of"] = {f[0]: f[1] for f in fallback}
    for idx in rng.permutation(len(names)).tolist():
        name = names[idx]
        b = a.MakePod(name).req({"cpu": "500m", "memory": "1Gi"})
        got = build[name](b) if name in build else b
        out["pods"].append(got if not hasattr(got, "obj") else got.obj())
    return out


def make_pod_group(name: str, min_member: int, namespace: str = "default"):
    """A PodGroup (api/podgroup.py) with quorum min_member."""
    from .api.podgroup import PodGroup, PodGroupSpec

    return PodGroup(metadata=ObjectMeta(name=name, namespace=namespace, uid=new_uid()),
                    spec=PodGroupSpec(min_member=min_member))


def pod_conservation_report(store, scheduler, keys):
    """Classify every submitted pod key at quiescence: each pod is exactly
    one of bound / pending / terminally failed, never lost, never bound
    twice. Returns {"bound", "pending", "failed", "lost", "double_bound",
    "counts"}, the first five lists of keys.

      bound         spec.node_name set in the store (the source of truth)
      pending       unbound, non-terminal, and tracked by the queue (any
                    tier, gang staging and parking included) or still
                    assumed in the cache
      failed        terminal phase
      lost          none of the above
      double_bound  bound more than once in the store's event history, or
                    accounted on two nodes in the scheduler cache

    A coordinator (scheduler/partition.py PartitionedScheduler,
    scheduler/mpsched.py MPScheduler) exposes conservation_members(): (its
    live pipelines, its residual pipeline or None). Pending-tracking is the
    UNION of their queues and caches; the pipelines' caches are DISJOINT, so
    one pod accounted by two of them is the cross-partition double, while
    the residual's cache deliberately MIRRORS every bound pod and is
    checked for internal duplicates alone.
    """
    pods = {p.key: p for p in store.list("pods")[0]}
    members = getattr(scheduler, "conservation_members", None)
    if members is not None:
        disjoint, mirror = members()
        trackers = list(disjoint) + ([mirror] if mirror is not None else [])
    else:
        disjoint, mirror = [scheduler], None
        trackers = [scheduler]
    queue_keys = set()
    for s in trackers:
        queue_keys.update(s.queue.tracked_keys())
    bound, pending, failed, lost = [], [], [], []
    for key in keys:
        pod = pods.get(key)
        if pod is None:
            lost.append(key)
        elif pod.spec.node_name:
            bound.append(key)
        elif pod.is_terminal():
            failed.append(key)
        elif key in queue_keys or any(s.cache.is_assumed(key) for s in trackers):
            pending.append(key)
        else:
            lost.append(key)
    keyset = set(keys)
    # the store's history (columnar bind batches flattened into their
    # per-object events): unbound -> bound transitions per key
    bind_counts: Dict[str, int] = {}
    for ev in store.history_events():
        if ev.kind != "pods" or ev.type != "MODIFIED":
            continue
        obj, prev = ev.obj, ev.prev
        if obj.spec.node_name and (prev is None or not prev.spec.node_name) \
                and obj.key in keyset:
            bind_counts[obj.key] = bind_counts.get(obj.key, 0) + 1
    double: List[str] = [k for k, n in bind_counts.items() if n > 1]

    def accounted(s) -> Dict[str, int]:
        # columnar cache rows collapse into PodInfos first, so the walk
        # counts every accounted pod, not only the materialized ones
        s.cache.materialize_columnar_rows()
        seen: Dict[str, int] = {}
        for ni in s.cache.update_snapshot().node_info_list:
            for pi in ni.pods:
                if pi.pod.key in keyset:
                    seen[pi.pod.key] = seen.get(pi.pod.key, 0) + 1
        return seen

    # the scheduler caches never account one pod on two nodes, merged over
    # the disjoint pipelines
    seen: Dict[str, int] = {}
    for s in disjoint:
        for k, n in accounted(s).items():
            seen[k] = seen.get(k, 0) + n
    double.extend(k for k, n in seen.items() if n > 1 and k not in double)
    if mirror is not None:
        double.extend(k for k, n in accounted(mirror).items() if n > 1 and k not in double)
    return {"bound": bound, "pending": pending, "failed": failed, "lost": lost,
            "double_bound": double,
            "counts": {"submitted": len(keys), "bound": len(bound), "pending": len(pending),
                       "failed": len(failed), "lost": len(lost), "double_bound": len(double)}}


def assert_pod_conservation(store, scheduler, keys):
    """Raise AssertionError unless every submitted pod is conserved (0 lost,
    0 bound twice). Returns the report."""
    rep = pod_conservation_report(store, scheduler, keys)
    assert not rep["lost"], (f"{len(rep['lost'])} pod(s) LOST (not bound, not queued, "
                             f"not terminal): {rep['lost'][:10]}")
    assert not rep["double_bound"], (f"{len(rep['double_bound'])} pod(s) DOUBLE-BOUND: "
                                     f"{rep['double_bound'][:10]}")
    return rep


def mutation_detector_guard(monkeypatch):
    """Shared body for a force-enabled mutation-detector autouse fixture.
    Use from a test module as

        @pytest.fixture(autouse=True)
        def _force_mutation_detector(monkeypatch):
            yield from mutation_detector_guard(monkeypatch)

    Every APIStore the module builds runs with the detector ON, and every
    store is checked at teardown — a consumer mutating an event object (or
    a store write reaching one) fails the module that caused it."""
    from .store import APIStore

    monkeypatch.setenv("CACHE_MUTATION_DETECTOR", "1")
    stores = []
    orig = APIStore.__init__

    def wrapped(self, *a, **kw):
        orig(self, *a, **kw)
        stores.append(self)

    monkeypatch.setattr(APIStore, "__init__", wrapped)
    yield
    for s in stores:
        s.check_mutations()


def transport_problem(seed, g, n, r=3, ties=False, scarce=False, dead_group=False,
                      supply_hi=60):
    """A seeded [G, N] transportation problem as numpy arrays: utility
    (integer-valued float32; 4 distinct values with ties, so levels tie),
    feasibility, free (negative on some nodes), requests (zero on some
    resources), slots, and jcap and supply derived as build_group_problem
    derives them; scarce shrinks free and slots below the demand."""
    rng = np.random.default_rng(seed)
    hi = 4 if ties else 400
    utility = rng.integers(0, hi, size=(g, n)).astype(np.float32)
    feasible = rng.random((g, n)) < 0.8
    free = rng.integers(-300, 2000 if scarce else 9000, size=(n, r)).astype(np.int32)
    req = rng.integers(50, 1500, size=(g, r)).astype(np.int32)
    req[rng.random((g, r)) < 0.2] = 0
    slots = rng.integers(0, 6 if scarce else 40, size=n).astype(np.int32)
    per = np.where(req[:, None, :] > 0,
                   np.floor_divide(free[None], np.maximum(req[:, None, :], 1)), 2**30)
    jcap = np.minimum(per.min(axis=2), slots[None, :])
    jcap = np.where(feasible, np.maximum(jcap, 0), 0).astype(np.int32)
    if dead_group:  # a group with no feasible node: its v row is all NEG_INF
        feasible[0] = False
        jcap[0] = 0
    supply = rng.integers(0, supply_hi, size=g).astype(np.int32)
    supply[0] = max(int(supply[0]), 1)
    return dict(utility=utility, feasible=feasible, jcap=jcap, supply=supply, slots=slots,
                req=req, free=free)


def overfilled_start(problem, seed, nodes=3):
    """A warm (x0, level0) for transport_problem's problem: on `nodes` nodes
    every feasible group holds several units, more than the node's slots
    and free admit (so the first round's knapsack must drop some), one cell
    holds a negative count, and the held cells carry seeded levels (one of
    them NEG_INF); every other cell is empty with a stale level."""
    rng = np.random.default_rng(seed)
    g, n = problem["utility"].shape
    x0 = np.zeros((g, n), np.int32)
    level0 = rng.integers(-50, 400, size=(g, n)).astype(np.float32)
    for j in rng.choice(n, size=min(nodes, n), replace=False):
        x0[:, j] = np.where(problem["feasible"][:, j],
                            int(problem["slots"][j]) + rng.integers(1, 5, size=g), 0)
    x0[rng.integers(g), rng.integers(n)] = -2
    held = np.argwhere(x0 > 0)
    if len(held):
        level0[tuple(held[0])] = np.float32(-1e30)
    return x0, level0


def auction_phase_touched(utility, jcap, supply, slots, req, free, x0, price0, level0,
                          eps, max_rounds, cs=16):
    """Test-only numpy model of kernel E's round (not on any main path):
    the nodes are dealt round robin to cs CTAs; a bidding group's K + 1 best
    nodes are merged from each CTA's own K + 1 best (value desc, lowest index
    on ties), and the accept step walks only the nodes that got
    a bid, plus, in round 1, every node whose x0 is not zero; every other
    node keeps its holders, level and price. In round 1 every empty cell's
    level becomes NEG_INF, as the reference's fold gives it. Returns (x, price,
    level, rounds) as _auction_phase_plain does."""
    f32 = np.float32
    utility = np.asarray(utility, f32)
    jcap, supply, slots = (np.asarray(a, np.int64) for a in (jcap, supply, slots))
    req, free = np.asarray(req, np.int64), np.asarray(free, np.int64)
    x = np.array(x0, np.int64)
    price, level = np.array(price0, f32), np.array(level0, f32)
    g, n = utility.shape
    neg = f32(-1e30)
    half = f32(neg / f32(2))
    k = min(16, n)
    walk = set(np.nonzero((x != 0).any(axis=0))[0].tolist())
    rounds, progress = 0, True

    def best(v, nodes):  # value desc, lowest index on ties (+0.0 == -0.0)
        return sorted(nodes, key=lambda j: (-float(v[j]), j))[:k + 1]

    while (supply - x.sum(axis=1) > 0).any() and progress and rounds < max_rounds:
        unassigned = supply - x.sum(axis=1)
        v = np.where(jcap > x, utility - price[None, :], neg).astype(f32)
        if rounds == 0:
            level = np.where(x == 0, neg, level).astype(f32)
        bids = {}  # node -> [(row, units, level)]
        progress = False
        for gi in range(g):
            if unassigned[gi] <= 0:
                continue
            lists = [best(v[gi], range(c, n, cs)) for c in range(cs)]
            merged = best(v[gi], [j for lst in lists for j in lst])
            top, vk = merged[:k], v[gi, merged[:k]]
            v_next = v[gi, merged[k]] if n > k else neg
            if v_next <= half:
                v_next = vk[k - 1] if vk[k - 1] > half else vk[0]
            if not vk[0] > half:
                continue
            run = 0
            for t, j in enumerate(top):
                avail = max(int(jcap[gi, j] - x[gi, j]), 0) if vk[t] > half else 0
                units = min(max(int(unassigned[gi]) - run, 0), avail)
                run += avail
                if units > 0:
                    progress = True
                    beta = f32(f32(utility[gi, j] - v_next) + f32(eps))
                    bids.setdefault(j, []).append((g + gi, units, max(neg, beta)))
                    walk.add(j)
        for j in sorted(walk):
            cands = [(gi, int(x[gi, j]), level[gi, j]) for gi in range(g) if x[gi, j] > 0]
            cands += bids.get(j, [])
            cands.sort(key=lambda c: (-float(c[2]), c[0]))  # stable: holders first
            used = np.zeros(req.shape[1], np.int64)
            count, top_rej = 0, None
            x[:, j] = 0
            level[:, j] = neg
            for row, u, lv in cands:
                gi = row if row < g else row - g
                rq = req[gi]
                fit = min([int((free[j, r] - used[r]) // rq[r]) for r in range(len(rq))
                           if rq[r] > 0] + [2**30, int(slots[j]) - count])
                kk = min(max(fit, 0), u) if lv > half else 0
                used += kk * rq
                count += kk
                if u - kk > 0:
                    top_rej = lv if top_rej is None else max(top_rej, lv)
                if kk > 0:
                    level[gi, j] = lv if x[gi, j] == 0 else min(level[gi, j], lv)
                    x[gi, j] += kk
            if top_rej is not None:
                price[j] = max(price[j], top_rej)
        walk = set()
        rounds += 1
    return x.astype(np.int32), price, level, rounds


_SENTINEL = -(2**31) + 1  # models/waterfill.py SENTINEL


def waterfill_select_model(key, group_size, k_slots, cs=16):
    """Test-only numpy model of kernel C's selection and order (not on any
    main path), from the [N, j_max] int32 keys of waterfill_keys_plain. The
    nodes are dealt in contiguous blocks to cs CTAs; each row's valid keys
    (key > SENTINEL) must be a prefix, strictly descending. The m-th largest
    key T (m = min(valid, group_size, k_slots)) comes from 4 radix passes of
    8 bits whose per-CTA histograms count the runs of equal digits in the
    CTA's concatenated rows (a run's first key adds minus its index, its
    last key its index + 1); c_n is row n's count of keys >= T (a binary
    search); each CTA sorts its chosen keys descending, and an entry's place
    in the greedy order is its place in its list plus every other CTA's
    count of chosen keys above it. Returns (k_per_node [N] int32,
    chosen_nodes [k_slots] int32) as waterfill_group_plain does."""
    key = np.asarray(key, np.int32)
    n, j_max = key.shape
    valid = key > _SENTINEL
    lens = valid.sum(axis=1)
    if not all(valid[i, :lens[i]].all() for i in range(n)):
        raise ValueError("a row's valid keys are not a prefix")
    u = np.where(valid, key.view(np.uint32) ^ np.uint32(0x80000000), np.uint32(0))
    chunk = -(-n // cs)
    ctas = [range(c * chunk, min(n, (c + 1) * chunk)) for c in range(cs)]
    rows = [np.concatenate([u[i, :lens[i]] for i in nodes] + [np.zeros(0, np.uint32)])
            for nodes in ctas]

    def histogram(arr, shift, prefix, first_pass):
        h = np.zeros(256, np.int64)
        ok = arr != 0
        if not first_pass:
            ok &= (arr >> np.uint32(shift + 8)) == (prefix >> (shift + 8))
        v = (arr >> np.uint32(shift)).astype(np.int64)
        for i in np.nonzero(ok)[0]:
            first = i == 0 or not ok[i - 1] or v[i - 1] != v[i]
            last = i + 1 == len(arr) or not ok[i + 1] or v[i + 1] != v[i]
            if first:
                h[v[i] & 255] -= i
            if last:
                h[v[i] & 255] += i + 1
        return h

    prefix, want, m = 0, 0, 0
    for p in range(4):
        shift = 24 - 8 * p
        merged = sum(histogram(arr, shift, prefix, p == 0) for arr in rows)
        if p == 0:
            m = int(min(merged.sum(), max(int(group_size), 0), k_slots))
            want = m
        if m == 0:
            break
        cum = 0
        for b in range(255, -1, -1):
            if cum + merged[b] >= want:
                prefix |= b << shift
                want -= cum
                break
            cum += int(merged[b])
    k_per_node = np.zeros(n, np.int32)
    chosen = np.full(k_slots, -1, np.int32)
    if m == 0:
        return k_per_node, chosen
    if want != 1:
        raise ValueError("keys at the threshold are not unique")
    thr = np.uint32(prefix)
    for i in range(n):  # rows descend: the count of keys >= T is a prefix length
        k_per_node[i] = len(u[i, :lens[i]]) - np.searchsorted(u[i, :lens[i]][::-1], thr)
    lists = []
    for nodes in ctas:
        ent = [(int(u[i, j]), i) for i in nodes for j in range(k_per_node[i])]
        lists.append(sorted(ent, reverse=True))
    neg = [-np.array([e[0] for e in lst], np.int64) for lst in lists]  # ascending
    for c, lst in enumerate(lists):
        if not lst:
            continue
        pos = np.arange(len(lst))
        for o in range(cs):
            if o != c:  # CTA o's chosen keys above each entry
                pos = pos + np.searchsorted(neg[o], neg[c], side="left")
        chosen[pos] = [node for _, node in lst]
    return k_per_node, chosen


def cover_curve_model(free, headroom, eligible, v_node, v_req, req):
    """Test-only numpy model of kernel G's victim-parallel curve for one
    slice (not on any main path): a stable counting sort of the victims by
    node (pads and nodes >= n_slots dropped), per resource a prefix sum of
    the node-sorted requests in uint32, a victim's freed resources as its
    prefix minus the prefix before its node's segment and its released slots
    as its rank on the node + 1, the capacity delta after minus before its
    eviction, caps[0] the sum of the base capacities, and a prefix sum into
    the curve. Returns caps[k_max + 1] int32 as cover_curve_plain does."""
    free = np.asarray(free, np.int64).astype(np.int32)
    head = np.asarray(headroom, np.int64).astype(np.int32)
    elig = np.asarray(eligible, bool)
    req = np.asarray(req, np.int64)
    ns, r = free.shape
    vn = np.asarray(v_node, np.int64)
    k_max = len(vn)
    v_req = np.asarray(v_req, np.int64).astype(np.int32).reshape(k_max, r)
    vn = np.where((vn >= 0) & (vn < ns), vn, -1)
    u32 = np.uint32

    def fdiv(a, b):  # floor division of int32 values
        return np.int64(a) // np.int64(b)

    def cap(avail, hd):
        c = 2**30
        for d in range(r):
            if req[d] > 0:
                c = min(c, fdiv(avail[d], req[d]))
        return max(min(c, int(hd)), 0)

    def i32(x):
        return int(np.array(x, np.int64).astype(u32).view(np.int32))

    # stable counting sort: the rank among the earlier victims on the node
    counts = np.zeros(ns, np.int64)
    rank = np.zeros(k_max, np.int64)
    for k in range(k_max):
        if vn[k] >= 0:
            rank[k] = counts[vn[k]]
            counts[vn[k]] += 1
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    n_valid = int(counts.sum())
    srt = np.zeros(n_valid, np.int64)
    for k in range(k_max):
        if vn[k] >= 0:
            srt[start[vn[k]] + rank[k]] = k
    pre = np.cumsum(v_req[srt].astype(u32), axis=0, dtype=u32) if n_valid else np.zeros((0, r), u32)
    curve = np.zeros(k_max + 1, u32)
    for k in range(k_max):
        n = vn[k]
        if n < 0 or not elig[n]:
            continue
        at, seg = start[n] + rank[k], start[n]
        freed = pre[at] - (pre[seg - 1] if seg > 0 else u32(0))
        after = [i32(np.int64(free[n, d]) + np.int64(freed[d])) for d in range(r)]
        before = [i32(np.int64(after[d]) - np.int64(v_req[k, d])) for d in range(r)]
        c_after = cap(after, i32(np.int64(head[n]) + rank[k] + 1))
        c_before = cap(before, i32(np.int64(head[n]) + rank[k]))
        curve[k + 1] = u32((c_after - c_before) % 2**32)
    base = sum(cap(free[n], head[n]) for n in range(ns) if elig[n])
    curve[0] = u32(base % 2**32)
    return np.cumsum(curve, dtype=u32).view(np.int32)


def defrag_problem(seed, ns, v, r=3, n_slots=None, v_max=None, zero_frac=0.1,
                   not_target=0.1):
    """Seeded padded arguments of one defrag_assign call, as numpy arrays
    (free [n_slots, R] int32, headroom [n_slots] int32, target_ok [n_slots]
    bool, v_req [v_max, R] int32, v_valid [v_max] bool): ns nodes of
    heterogeneous free capacity (millicore / MiB magnitudes, a few slightly
    negative), headroom 0-8 and a share that is not a target; v victims in
    drain order with mixed requests, a share of them zero and a few larger
    than any node (unplaceable). Pads as defrag_plan does (n_slots and
    v_max default to the powers of two)."""
    from .models.gangcover import _pow2

    rng = np.random.default_rng(seed)
    n_slots = n_slots or _pow2(ns)
    v_max = v_max or _pow2(v)
    free = np.zeros((n_slots, r), np.int32)
    free[:ns] = rng.integers(-200, 8000, size=(ns, r))
    head = np.zeros(n_slots, np.int32)
    head[:ns] = rng.integers(0, 9, size=ns)
    ok = np.zeros(n_slots, bool)
    ok[:ns] = rng.random(ns) >= not_target
    v_req = np.zeros((v_max, r), np.int32)
    v_req[:v] = rng.integers(0, 4000, size=(v, r))
    v_req[:v][rng.random(v) < zero_frac] = 0
    v_req[:v][rng.random(v) < 0.03] = 9000  # above every node
    valid = np.zeros(v_max, bool)
    valid[:v] = True
    return free, head, ok, v_req, valid


def defrag_edge_cases():
    """Kernel I's parity traps as named padded problems (numpy, as
    defrag_problem): identical nodes (ties to the lowest index), headroom 0,
    no target at all, pad rows between real victims and pad slots, negative
    free, and a waste sum that wraps int32 (a wrapped negative waste wins the
    argmin, as in XLA)."""
    cases = {}
    free = np.full((16, 3), 4000, np.int32)
    head = np.full(16, 2, np.int32)
    ok = np.ones(16, bool)
    v_req = np.tile(np.array([[1000, 1000, 0]], np.int32), (32, 1))
    v_req[5] = 0
    cases["ties"] = (free, head, ok, v_req, np.ones(32, bool))
    head0 = head.copy()
    head0[::2] = 0
    cases["headroom_0"] = (free, head0, ok, v_req, np.ones(32, bool))
    cases["no_target"] = (free, head, np.zeros(16, bool), v_req, np.ones(32, bool))
    free_p = free.copy()
    free_p[10:] = 0
    ok_p = ok.copy()
    ok_p[10:] = False
    valid = np.ones(32, bool)
    valid[1::3] = False
    cases["pad_rows_and_slots"] = (free_p, head, ok_p, v_req, valid)
    rng = np.random.default_rng(7)
    free_n = rng.integers(-3000, 3000, size=(64, 2)).astype(np.int32)
    v_n = rng.integers(-10, 1500, size=(64, 2)).astype(np.int32)
    cases["negative_free"] = (free_n, rng.integers(0, 3, size=64).astype(np.int32),
                              rng.random(64) > 0.2, v_n, np.ones(64, bool))
    free_w = np.full((8, 3), 2**30 + 5, np.int32)
    free_w[3] = 100
    v_w = np.zeros((4, 3), np.int32)
    v_w[:, 0] = 1
    cases["wrapping_sum"] = (free_w, np.full(8, 3, np.int32), np.ones(8, bool), v_w,
                             np.array([True, True, True, False]))
    return cases


def defrag_request_runs(seed, ns, v, r=3, n_slots=None, max_run=64, ties=False,
                        headroom0=0.0, not_target=0.1, negative=False, wrap=False,
                        pads=0.05):
    """Seeded padded arguments of one defrag_assign call (as defrag_problem)
    whose victims come in runs of identical requests, 1 to max_run long:
    the shape kernel I's tournament tree is built for (Defrag_5000's cycle
    is one run of 3-cpu fillers). ties: every node the same free capacity;
    headroom0: that share of nodes with headroom 0; not_target: that share
    no target; negative: some free below 0; wrap: free near 2^30, so the
    waste sum wraps int32; pads: that share of victims in the middle of runs
    marked invalid (their requests equal to the run's), beside the trailing
    pads of the power-of-two bucket."""
    from .models.gangcover import _pow2

    rng = np.random.default_rng(seed)
    n_slots = n_slots or _pow2(ns)
    v_max = _pow2(v)
    free = np.zeros((n_slots, r), np.int32)
    if ties:
        free[:ns] = rng.integers(1000, 8000, size=r)
    elif wrap:
        free[:ns] = rng.integers(2**30 - 4000, 2**30, size=(ns, r))
    else:
        free[:ns] = rng.integers(-400 if negative else 0, 8000, size=(ns, r))
    head = np.zeros(n_slots, np.int32)
    head[:ns] = rng.integers(1, 9, size=ns)
    head[:ns][rng.random(ns) < headroom0] = 0
    ok = np.zeros(n_slots, bool)
    ok[:ns] = rng.random(ns) >= not_target
    v_req = np.zeros((v_max, r), np.int32)
    valid = np.zeros(v_max, bool)
    k = 0
    while k < v:
        run = min(int(rng.integers(1, max_run + 1)), v - k)
        req = rng.integers(0, 4000, size=r)
        if rng.random() < 0.1:
            req[:] = 0
        elif rng.random() < 0.05:
            req[0] = 9000  # above every node
        v_req[k:k + run] = req
        valid[k:k + run] = True
        k += run
    inner = np.nonzero(rng.random(v) < pads)[0]
    valid[inner] = False
    return free, head, ok, v_req, valid


# named runs of identical requests (defrag_request_runs keywords): kernel I's
# CPU model tests and card tests, and chip_smoke's e_request_runs
DEFRAG_RUNS = {
    "runs": dict(ns=600, v=250),
    "runs_r1": dict(ns=300, v=120, r=1),
    "runs_r4": dict(ns=300, v=200, r=4),
    "single_victim_runs": dict(ns=200, v=100, max_run=1),
    "long_runs": dict(ns=500, v=256, max_run=64, pads=0.0),
    "ties": dict(ns=400, v=200, ties=True),
    "headroom_0": dict(ns=400, v=200, headroom0=0.5),
    "no_target": dict(ns=200, v=64, not_target=1.0),
    "pads_mid_run": dict(ns=300, v=200, pads=0.3),
    "negative_free": dict(ns=300, v=200, negative=True),
    "wrapping_sum": dict(ns=300, v=150, r=3, wrap=True),
    "scarce": dict(ns=40, v=256, max_run=64),
    "not_a_group_multiple": dict(ns=129, v=64, n_slots=129),
    "one_slot": dict(ns=1, v=16),
}


def defrag_run_case(name):
    """DEFRAG_RUNS[name]'s arguments, seeded by the name."""
    return defrag_request_runs(sum(map(ord, name)), **DEFRAG_RUNS[name])


_DEFRAG_BIG = 2**30


def defrag_tree_model(free, headroom, target_ok, v_req, v_valid, group=None):
    """Test-only numpy model of kernel I's schedule (not on any main path):
    a tournament tree of packed keys (ord(key) << 32 | slot, the minimum the
    argmin with the lowest index on ties): leaves, each the minimum over
    `group` slots (default: the kernel's, ops/kernels.py defrag_group), and
    their minimum, the root. A valid victim whose request differs from the
    tree's rebuilds it; one with the tree's request takes the root, after
    recomputing the leaf of the last placement's target if that is stale; a
    placement leaves its target's leaf stale; an unplaced or pad victim
    changes nothing. Returns (out [v_max] int32, counts: rebuilds,
    leaf_updates, root_reads, pads)."""
    st = np.asarray(free, np.int64).copy()
    head = np.where(np.asarray(target_ok, bool), np.asarray(headroom, np.int64), 0)
    v_req = np.asarray(v_req, np.int64)
    v_valid = np.asarray(v_valid, bool)
    ns = st.shape[0]
    if group is None:
        from .ops.kernels import defrag_group

        group = defrag_group(ns)

    def leaf(vr, g):
        lo, hi = g * group, min(ns, (g + 1) * group)
        fits = (st[lo:hi] >= vr[None, :]).all(axis=1) & (head[lo:hi] > 0)
        waste = (st[lo:hi] - vr[None, :]).sum(axis=1)
        waste = ((waste + 2**31) % 2**32) - 2**31  # the int32 sum wraps
        key = np.where(fits, waste, _DEFRAG_BIG)
        ordk = (key.astype(np.int64) + 2**31).astype(np.uint64)  # sign bit flipped
        return int(((ordk << np.uint64(32)) | np.arange(lo, hi, dtype=np.uint64)).min())

    leaves = None
    tree_req = None
    pending = -1
    counts = dict(rebuilds=0, leaf_updates=0, root_reads=0, pads=0)
    out = np.full(len(v_req), -1, np.int32)
    for k, vr in enumerate(v_req):
        if not v_valid[k]:
            counts["pads"] += 1
            continue
        if tree_req is None or not np.array_equal(vr, tree_req):
            leaves = [leaf(vr, g) for g in range(-(-ns // group))]
            tree_req, pending = vr.copy(), -1
            counts["rebuilds"] += 1
        elif pending >= 0:
            leaves[pending // group] = leaf(vr, pending // group)
            pending = -1
            counts["leaf_updates"] += 1
        counts["root_reads"] += 1
        root = min(leaves)
        key = (root >> 32) - 2**31
        if key < _DEFRAG_BIG:
            tgt = root & 0xFFFFFFFF
            st[tgt] -= vr
            head[tgt] -= 1
            out[k] = tgt
            pending = tgt
    return out, counts


def _wrap32(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


def feasibility_tiles_model(f, reqs, req_nzs, clss, bals, tiles=16):
    """Test-only numpy model of kernel J's layout (not on any main path):
    the N nodes dealt in `tiles` contiguous tiles of ceil(N / tiles) (a
    cluster's CTAs); per row, each node's feasibility and partial total
    (least + balanced + image), each tile's two normalizer maxima over its
    feasible nodes (0 for a tile with none), their maximum, then + 2 napref
    + 3 taint. The host-port test (over every port column) runs only where
    the row's class sets a port column. `f` maps SolverInputs fields to
    numpy arrays.
    Returns (feas [Rw, N] bool, total [Rw, N] int32, tile maxima [Rw, tiles,
    2] int32, the rows that ran a port test)."""
    alloc = np.asarray(f["alloc"], np.int64)
    used = np.asarray(f["used"], np.int64)
    used_nz = np.asarray(f["used_nz"], np.int64)
    n, r = alloc.shape
    free = _wrap32(alloc - used)
    pod_ok = _wrap32(np.asarray(f["pod_count"], np.int64) + 1) <= np.asarray(f["max_pods"])
    chunk = -(-n // tiles)
    rw = len(reqs)
    feas = np.zeros((rw, n), bool)
    total = np.zeros((rw, n), np.int32)
    tile_max = np.zeros((rw, tiles, 2), np.int32)
    port_rows = []
    for i in range(rw):
        cls = max(int(clss[i]), 0)
        req = np.asarray(reqs[i], np.int64)
        rnz = np.asarray(req_nzs[i], np.int64)
        ok = np.asarray(f["filter_ok"][cls], bool) & pod_ok
        ok &= ((req[None, :] == 0) | (req[None, :] <= free)).all(axis=1)
        cports = np.asarray(f["class_ports"][cls], bool)
        if cports.any():
            port_rows.append(i)
            ok &= ~(np.asarray(f["node_ports"], bool) & cports[None, :]).any(axis=1)
        per_sum = np.zeros(n, np.int64)
        npos = np.zeros(n, np.int64)
        for d in range(2):
            a_d = alloc[:, d]
            u = _wrap32(used_nz[:, d] + rnz[d])
            pos = a_d > 0
            npos += pos
            term = _wrap32(_wrap32(a_d - u) * 100) // np.maximum(a_d, 1)
            per_sum = _wrap32(per_sum + np.where(pos & (u <= a_d), term, 0))
        least = per_sum // np.maximum(npos, 1)
        bal = np.zeros(n, np.int64)
        if bool(bals[i]):
            af = alloc[:, :2].astype(np.float32)
            u = _wrap32(used[:, :2] + req[None, :2]).astype(np.float32)
            frac = np.where(af > 0, np.minimum(u / np.maximum(af, np.float32(1)),
                                               np.float32(1)), np.float32(0)).astype(np.float32)
            nf = (af > 0).sum(axis=1)
            sd = np.where(nf == 2, np.abs(frac[:, 0] - frac[:, 1]) / np.float32(2),
                          np.float32(0)).astype(np.float32)
            bal = ((np.float32(1) - sd) * np.float32(100)).astype(np.float32).astype(np.int64)
        part = _wrap32(least + bal + np.asarray(f["img_score"][cls], np.int64))
        nap = np.asarray(f["napref_raw"][cls], np.int64)
        taint = np.asarray(f["taint_cnt"][cls], np.int64)
        for t in range(tiles):
            sl = slice(t * chunk, min(n, (t + 1) * chunk))
            fe = ok[sl]
            tile_max[i, t, 0] = max(0, int(nap[sl][fe].max())) if fe.any() else 0
            tile_max[i, t, 1] = max(0, int(taint[sl][fe].max())) if fe.any() else 0
        mxn, mxt = (int(x) for x in tile_max[i].max(axis=0))
        napref = np.zeros(n, np.int64)
        if bool(f["has_napref"][cls]) and mxn > 0:
            napref = _wrap32(100 * nap) // mxn
        tnorm = 100 - _wrap32(100 * taint) // mxt if mxt > 0 else np.full(n, 100, np.int64)
        feas[i] = ok
        total[i] = _wrap32(part + _wrap32(2 * napref + 3 * _wrap32(tnorm)))
    return feas, total, tile_max, port_rows


def scan_problem(seed, n, p, c=4, r=3, zones=5, hostname=True, identical=False,
                 huge_every=7, gang=True):
    """A seeded greedy-scan problem as numpy arrays keyed by SolverInputs
    field, and its d_max: n nodes with heterogeneous capacity and load, c
    classes with filter/affinity rows, preferred node affinity and taint
    counts (some classes with all-zero rows), host ports, topology keys zone
    (zones domains) and, when hostname, a hostname key (d_max = n) with some
    nodes missing a label, selector-class and holder-group counts, every
    inter-pod-affinity table family, DoNotSchedule (some with minDomains)
    and ScheduleAnyway spread rows, and p pods, every huge_every-th one
    larger than any node. identical gives n identical nodes, one class and
    no constraint terms (argmax ties everywhere). Any n >= 1 works, so the
    card tests can reach shapes the tensorizer would take long to build."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, size=shape).astype(np.int32)

    pt, sc, g, kk = 2, 3, 2, 2 if hostname else 1
    if identical:
        c = 1
        alloc = np.tile(np.array([[8000, 32768, 0] + [4] * (r - 3)], np.int32)[:, :r], (n, 1))
        used = np.zeros((n, r), np.int32)
        used_nz = np.zeros((n, r), np.int32)
        pod_count = np.zeros(n, np.int32)
        max_pods = np.full(n, 110, np.int32)
    else:
        alloc = np.stack([ints(2000, 16001, n), ints(4096, 65537, n), ints(0, 3, n) * 1000]
                         + [ints(0, 5, n) for _ in range(r - 3)], axis=1)[:, :r]
        used = (alloc * rng.random((n, r)) * 0.6).astype(np.int32)
        used_nz = np.maximum(used, np.array([100, 200, 0] + [0] * (r - 3), np.int32)[:r])
        used_nz = np.minimum(used_nz, alloc)
        pod_count = ints(0, 12, n)
        max_pods = ints(10, 111, n)
    topo = [np.arange(n, dtype=np.int32) % max(zones, 1)]
    if hostname:
        topo.append(np.arange(n, dtype=np.int32))
    topo_id = np.stack(topo)
    if not identical:
        topo_id[rng.random(topo_id.shape) < 0.04] = -1
    d_max = max(int(topo_id.max()) + 1, 1)

    def table(m, lo, hi, pad=0.4):
        t = ints(lo, hi, (c, m))
        if not identical:
            t[rng.random((c, m)) < pad] = -1
        else:
            t[:] = -1
        return t

    f = {}
    f.update(alloc=alloc, used=used, used_nz=used_nz, pod_count=pod_count, max_pods=max_pods)
    f["filter_ok"] = np.ones((c, n), bool) if identical else rng.random((c, n)) < 0.92
    f["aff_ok"] = np.ones((c, n), bool) if identical else rng.random((c, n)) < 0.9
    f["napref_raw"] = np.zeros((c, n), np.int32) if identical else ints(0, 60, (c, n))
    f["has_napref"] = np.zeros(c, bool) if identical else rng.random(c) < 0.6
    f["taint_cnt"] = np.zeros((c, n), np.int32) if identical else ints(0, 3, (c, n)) * (
        rng.random((c, n)) < 0.2)
    if not identical:
        f["napref_raw"][0] = 0  # a class whose rows need no extrema
        f["taint_cnt"][0] = 0
    f["img_score"] = np.zeros((c, n), np.int32) if identical else ints(0, 25, (c, n))
    f["class_ports"] = np.zeros((c, pt), bool) if identical else rng.random((c, pt)) < 0.25
    f["node_ports"] = np.zeros((n, pt), bool) if identical else rng.random((n, pt)) < 0.05
    f["topo_id"] = topo_id
    f["selcls_count"] = np.zeros((sc, n), np.int32) if identical else ints(0, 3, (sc, n)) * (
        rng.random((sc, n)) < 0.3)
    f["class_matches_selcls"] = ints(0, 2, (c, sc))
    ct = 0 if identical else 3
    st = 0 if identical else 2
    f["ct_class"] = ints(0, c, ct) if ct else np.full(1, -1, np.int32)
    f["ct_key"] = ints(0, kk, max(ct, 1)) if ct else np.zeros(1, np.int32)
    f["ct_sel"] = ints(0, sc, max(ct, 1)) if ct else np.zeros(1, np.int32)
    f["ct_max_skew"] = ints(1, 4, max(ct, 1))
    f["ct_min_domains"] = ints(0, 2, max(ct, 1)) * ints(2, 7, max(ct, 1))
    f["ct_self_match"] = ints(0, 2, max(ct, 1))
    f["st_class"] = ints(0, c, st) if st else np.full(1, -1, np.int32)
    f["st_key"] = ints(0, kk, max(st, 1)) if st else np.zeros(1, np.int32)
    f["st_sel"] = ints(0, sc, max(st, 1)) if st else np.zeros(1, np.int32)
    f["st_max_skew"] = ints(1, 4, max(st, 1))
    f["st_self_match"] = ints(0, 2, max(st, 1))
    f["ra_key"], f["ra_sel"] = table(2, 0, kk, pad=0.75), ints(0, sc, (c, 2))
    f["rn_key"], f["rn_sel"] = table(2, 0, kk, pad=0.6), ints(0, sc, (c, 2))
    f["pp_key"], f["pp_sel"] = table(3, 0, kk), ints(0, sc, (c, 3))
    f["pp_weight"] = ints(-50, 51, (c, 3))
    f["grp_key"] = ints(0, kk, g)
    f["grp_count"] = np.zeros((g, n), np.int32) if identical else ints(0, 2, (g, n)) * (
        rng.random((g, n)) < 0.1)
    f["class_holds_grp"] = ints(0, 2, (c, g))
    f["ea_grp"] = table(2, 0, g, pad=0.6)
    f["sym_grp"] = table(2, 0, g)
    f["sym_weight"] = ints(-30, 31, (c, 2))
    f["class_self_ok"] = rng.random(c) < 0.5
    f["class_has_ra"] = (f["ra_key"] >= 0).any(axis=1)
    req = np.stack([ints(0, 1500, p), ints(0, 3000, p), ints(0, 2, p) * 500]
                   + [ints(0, 2, p) for _ in range(r - 3)], axis=1)[:, :r]
    if identical:
        req = np.tile(np.array([[500, 1024, 0] + [0] * (r - 3)], np.int32)[:, :r], (p, 1))
    elif huge_every:
        req[::huge_every, 0] = 10**6  # fits nowhere
    f["req"] = req.astype(np.int32)
    f["req_nz"] = np.maximum(req, np.array([100, 200, 0] + [0] * (r - 3))[:r]).astype(np.int32)
    f["class_of_pod"] = ints(0, c, p)
    f["balanced_active"] = (req[:, 0] != 0) | (req[:, 1] != 0)
    f["gang_bonus"] = ints(0, 40, (c, n)) if gang and not identical else None
    return f, d_max


def mirror_churn_rounds(seed, n, r=3, sc=4, rounds=6, ks=None):
    """Seeded host cluster arrays (the DEVICE_FIELDS and selcls_count) and
    churn rounds over them: yields (cluster, dirty rows) after each round
    rewrote those rows. ks fixes the dirty count per round (default: seeded,
    1 to n); the arrays are changed in place, as the tensorizer does."""
    rng = np.random.default_rng(seed)
    cl = SimpleNamespace(
        alloc=rng.integers(0, 1 << 20, size=(n, r)).astype(np.int32),
        used=rng.integers(0, 1 << 20, size=(n, r)).astype(np.int32),
        used_nz=rng.integers(0, 1 << 20, size=(n, r)).astype(np.int32),
        pod_count=rng.integers(0, 110, size=n).astype(np.int32),
        max_pods=rng.integers(0, 111, size=n).astype(np.int32),
        selcls_count=rng.integers(0, 50, size=(sc, n)).astype(np.int32))
    for i in range(rounds):
        k = ks[i % len(ks)] if ks else int(rng.integers(1, n + 1))
        rows = np.sort(rng.choice(n, size=k, replace=False))
        for f in ("alloc", "used", "used_nz"):
            getattr(cl, f)[rows] = rng.integers(-(1 << 30), 1 << 30, size=(k, r))
        cl.pod_count[rows] = rng.integers(0, 110, size=k)
        cl.max_pods[rows] = rng.integers(0, 111, size=k)
        cl.selcls_count[:, rows] = rng.integers(0, 50, size=(sc, k))
        yield cl, rows


def repair_problem(seed, n, p, d_max, kk=2, sc=3, g=2, c=4, ct=2, terms=2, missing=0.1,
                   placed=0.9, wrap=False, min_domains_over=False):
    """Seeded numpy arguments of repair_check (its order, without d_max) for
    n nodes and p pods padded to a pow2 bucket >= 2: topology rows with ids
    in [0, d_max) (a `missing` share of nodes without the key), small count
    rows (near 2^31 where `wrap`, so domain sums wrap), every term family
    with unused (-1) slots, holders' groups, spread rows (one of class -1),
    minDomains above the domain count where `min_domains_over`, unplaced pods
    and pad rows. Returns the args tuple."""
    rng = np.random.default_rng(seed)
    pb = max(2, 1 << max(0, p - 1).bit_length())
    topo = rng.integers(0, d_max, size=(kk, n)).astype(np.int32)
    topo[rng.random((kk, n)) < missing] = -1
    sel = np.where(rng.random((sc, n)) < 0.3, rng.integers(1, 4, size=(sc, n)), 0)
    grp = np.where(rng.random((g, n)) < 0.2, rng.integers(1, 3, size=(g, n)), 0)
    if wrap:
        big = rng.random((sc, n)) < 0.05
        sel = np.where(big, 2**31 - 1 - rng.integers(0, 5, size=(sc, n)), sel)
    node_of = np.full(pb, -1, np.int32)
    node_of[:p] = np.where(rng.random(p) < placed, rng.integers(0, n, size=p), -1)
    cls_of = np.zeros(pb, np.int32)
    cls_of[:p] = rng.integers(0, c, size=p)

    def term(hi):
        t = rng.integers(-1, hi, size=(c, terms)).astype(np.int32)
        t[0, :] = -1  # class 0 has no term of this family
        return t

    rn_key, ra_key = term(kk), term(kk)
    rn_sel = rng.integers(-1, sc, size=(c, terms)).astype(np.int32)
    ra_sel = rng.integers(-1, sc, size=(c, terms)).astype(np.int32)
    ea_grp = term(g)
    cm = (rng.random((c, sc)) < 0.5).astype(np.int32)
    ch = (rng.random((c, g)) < 0.5).astype(np.int32)
    grp_key = rng.integers(0, kk, size=g).astype(np.int32)
    aff_ok = rng.random((c, n)) < 0.8
    ct_class = rng.integers(0, c, size=ct).astype(np.int32)
    ct_class[0] = -1 if ct > 1 else ct_class[0]
    ct_key = rng.integers(0, kk, size=ct).astype(np.int32)
    ct_sel = rng.integers(0, sc, size=ct).astype(np.int32)
    skew = rng.integers(1, 4, size=ct).astype(np.int32)
    mind = np.where(rng.random(ct) < 0.5, rng.integers(1, 3, size=ct), 0).astype(np.int32)
    if min_domains_over:
        mind[:] = d_max + 1
    return (node_of, cls_of, sel.astype(np.int32), grp.astype(np.int32), topo, rn_key, rn_sel,
            ea_grp, ra_key, ra_sel, cm, ch, grp_key, aff_ok, ct_class, ct_key, ct_sel, skew,
            mind)


def repair_check_model(args, d_max, has_affinity=True, has_ct=True, cs=16):
    """Test-only numpy model of kernel D's schedule (not on any main path),
    on the plan ops/kernels.py repair_plan gives for a cluster of `cs` CTAs:
    CTA r adds the values of its nodes [r * node_chunk, ...) into the domain
    table (rows: the (key, count row) pairs, then per spread row its counts
    and eligible nodes), as a partial table of its own (mode 0, then every
    CTA sums the cs partials) or straight into the owner's slice of the
    domains (modes 1 and 2); the spread rows' n_valid and minimum are
    reduced over all domains (mode 0) or per owner slice, then over the
    slices; CTA r tests its pods [r * pod_chunk, ...) against the totals.
    int32 sums wrap. Returns (masks [4, Pb] bool, info: the plan, each CTA's
    partial table (mode 0) or each owner's slice, the spread rows'
    per-slice (n_valid, min) and their minima)."""
    from .ops.kernels import repair_plan

    (node_of, cls_of, sel, grp, topo, rn_key, rn_sel, ea_grp, ra_key, ra_sel, cm, ch, grp_key,
     aff_ok, ct_class, ct_key, ct_sel, skew, mind) = [np.asarray(a) for a in args]
    pb = node_of.shape[0]
    kk, n = topo.shape
    sc, g = sel.shape[0], grp.shape[0]
    m_rows = sc + g
    ct = ct_class.shape[0]
    has_ct = bool(has_ct) and ct > 0
    plan = repair_plan(pb, n, kk, m_rows, ct, d_max, bool(has_affinity), has_ct, cs)
    mode, rows, sl = plan["mode_id"], plan["rows"], plan["domains_per_cta"]
    r_aff = kk * m_rows if has_affinity else 0
    counts = np.concatenate([sel, grp]).astype(np.int64)
    # each row's value and domain per node (a value of 0 adds nothing)
    vals = np.zeros((rows, n), np.int64)
    dom = np.full((rows, n), -1, np.int64)
    for k in range(kk if has_affinity else 0):
        vals[k * m_rows:(k + 1) * m_rows] = counts
        dom[k * m_rows:(k + 1) * m_rows] = topo[k]
    for j in range(ct if has_ct else 0):
        ok = aff_ok[max(int(ct_class[j]), 0)]
        dom[r_aff + 2 * j] = dom[r_aff + 2 * j + 1] = np.where(ok, topo[ct_key[j]], -1)
        vals[r_aff + 2 * j] = sel[ct_sel[j]]
        vals[r_aff + 2 * j + 1] = 1
    adds = (dom >= 0) & (dom < d_max) & (vals != 0)
    chunk = plan["nodes_per_cta"]
    width = d_max if mode == 0 else cs * sl
    totals = np.zeros((rows, width), np.uint64)
    parts = []
    for r in range(cs):
        lo, hi = r * chunk, min(n, (r + 1) * chunk)
        rr, nn_ = np.nonzero(adds[:, lo:hi])
        part = np.zeros((rows, width), np.uint64)
        np.add.at(part, (rr, dom[rr, lo + nn_]), vals[rr, lo + nn_].astype(np.uint64) % 2**32)
        parts.append(part % 2**32)
        totals += part
    totals = _wrap32(totals % 2**32).astype(np.int64)
    if mode:  # the owners' slices
        parts = [totals[:, q * sl:(q + 1) * sl] for q in range(cs)]
    ctmin = np.zeros(ct, np.int64)
    slice_minima = []
    for j in range(ct if has_ct else 0):
        cnt, elig = totals[r_aff + 2 * j, :d_max], totals[r_aff + 2 * j + 1, :d_max]
        spans = [(0, d_max)] if mode == 0 else [(q * sl, min(d_max, (q + 1) * sl))
                                               for q in range(cs)]
        part = []
        for lo, hi in spans:
            valid = elig[lo:hi] > 0
            part.append((int(valid.sum()), int(cnt[lo:hi][valid].min()) if valid.any() else 2**30))
        slice_minima.append(part)
        nv, mn = sum(x for x, _ in part), min(y for _, y in part)
        if (mind[j] > 0 and mind[j] > nv) or nv == 0:
            mn = 0
        ctmin[j] = mn
    masks = np.zeros((4, pb), bool)
    pchunk = plan["pods_per_cta"]
    for r in range(cs):
        lo, hi = r * pchunk, min(pb, (r + 1) * pchunk)
        if lo >= hi:
            continue
        nd = node_of[lo:hi].astype(np.int64)
        placed = nd >= 0
        nn_ = np.maximum(nd, 0)
        cc = np.maximum(cls_of[lo:hi], 0).astype(np.int64)

        def total(row, t):
            return totals[row, np.minimum(t, d_max - 1)]

        if has_affinity:
            for j in range(rn_key.shape[1]):
                k, s0 = rn_key[cc, j], np.maximum(rn_sel[cc, j], 0)
                t = topo[np.maximum(k, 0), nn_]
                other = _wrap32(total(np.maximum(k, 0) * m_rows + s0, np.maximum(t, 0))
                                - cm[cc, s0])
                masks[0, lo:hi] |= placed & (k >= 0) & (t >= 0) & (other > 0)
            for j in range(ea_grp.shape[1]):
                gg = ea_grp[cc, j]
                g0 = np.maximum(gg, 0)
                k = grp_key[g0]
                t = topo[k, nn_]
                other = _wrap32(total(k * m_rows + sc + g0, np.maximum(t, 0)) - ch[cc, g0])
                masks[1, lo:hi] |= placed & (gg >= 0) & (t >= 0) & (other > 0)
            for j in range(ra_key.shape[1]):
                k, s0 = ra_key[cc, j], np.maximum(ra_sel[cc, j], 0)
                t = topo[np.maximum(k, 0), nn_]
                tot = total(np.maximum(k, 0) * m_rows + s0, np.maximum(t, 0))
                masks[2, lo:hi] |= placed & (k >= 0) & ((t < 0) | (tot <= 0))
        for j in range(ct if has_ct else 0):
            t = topo[ct_key[j], nn_]
            node_dc = np.where(t >= 0, total(r_aff + 2 * j, np.maximum(t, 0)), 0)
            bad = (t < 0) | (_wrap32(node_dc - ctmin[j]) > skew[j])
            masks[3, lo:hi] |= placed & (ct_class[j] >= 0) & (ct_class[j] == cc) & bad
    info = dict(plan=plan, partials=parts, slice_minima=slice_minima, ct_min=ctmin)
    return masks, info


def _align_keys(group, key):
    """Kernel H's packed row keys: (group, key) with the sign bits flipped,
    as one uint64 (signed order becomes unsigned order)."""
    hi = (np.asarray(group, np.int32).view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    lo = (np.asarray(key, np.int32).view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


_RA_WARPS = 32  # RA_WARPS in csrc/rank_align.cu
_RA_INF = (np.uint64(2**64 - 1), 2**32 - 1)


def _rows_less(ka, xa, kb, xb):
    return (ka < kb) | ((ka == kb) & (xa < xb))


def _warp_merge(sk, sx, dk, dx, pb, L, o, cnt):
    """Kernel H's warp_merge: the outputs [o, o + cnt) of the merge of the
    runs sk/sx[pb:pb + L] and [pb + L:pb + 2L] into dk/dx[pb + o:...]: a
    32-ary search on the merge path (one probe a lane, the ballot's count),
    then windows of 32 rows a run, each row placed by its count of the other
    window's rows below it."""
    lane = np.arange(32)
    lo, hi = max(0, o - L), min(o, L)
    while lo < hi:
        span = hi - lo
        i = lo + ((span * lane) >> 5)
        j = pb + L + o - 1 - i
        c = int(_rows_less(sk[pb + i], sx[pb + i], sk[j], sx[j]).sum())
        if c == 0:
            hi = lo
        else:
            last = lo + ((span * (c - 1)) >> 5)
            hi = lo + ((span * c) >> 5) if c < 32 else hi
            lo = last + 1
    a, b = lo, o - lo

    def window(run, start):  # the run's next 32 rows, sentinels past its end
        at = start + lane
        ok = at < L
        k = np.where(ok, sk[pb + run + np.minimum(at, L - 1)], _RA_INF[0])
        x = np.where(ok, sx[pb + run + np.minimum(at, L - 1)], _RA_INF[1])
        return k, x

    for w in range(0, cnt, 32):
        ka, xa = window(0, a)
        kb, xb = window(L, b)
        # each row's count of the other window's rows below it
        qa = lane + _rows_less(kb[None, :], xb[None, :], ka[:, None], xa[:, None]).sum(axis=1)
        qb = lane + _rows_less(ka[None, :], xa[None, :], kb[:, None], xb[:, None]).sum(axis=1)
        for q, k, x in ((qa, ka, xa), (qb, kb, xb)):
            put = q < 32
            dk[pb + o + w + q[put]] = k[put]
            dx[pb + o + w + q[put]] = x[put]
        ta = int((qa < 32).sum())
        a, b = a + ta, b + 32 - ta


def _warp_bitonic(k, x):
    """Kernel H's warp_sort32 on every 32 rows at once: the bitonic network
    of shuffles, (k, x) rows, ascending."""
    k, x = k.copy(), x.copy()
    i = np.arange(k.shape[0])
    lane = i % 32
    kk = 2
    while kk <= 32:
        j = kk // 2
        while j:
            pk, px = k[i ^ j], x[i ^ j]
            keep_min = ((lane & j) == 0) == ((lane & kk) == 0)
            take = _rows_less(k, x, pk, px) != keep_min
            k, x = np.where(take, pk, k), np.where(take, px, x)
            j //= 2
        kk *= 2
    return k, x


def _chunk_sort(keys, base, n, steps):
    """Kernel H's chunk_sort of rows base .. base + n - 1: each warp's 32
    rows by the bitonic network, then merge levels of warp_merge calls (a
    warp's cnt = max(32, n / 32) outputs, a pair at a time), a block barrier
    each. Returns (keys, row indices) in order."""
    k = np.full(max(n, 32), _RA_INF[0])
    x = np.full(max(n, 32), _RA_INF[1], np.int64)
    k[:n], x[:n] = keys[base:base + n], np.arange(base, base + n)
    k, x = _warp_bitonic(k, x)
    k, x = k[:n], x[:n]
    L = 32
    while L < n:
        if steps is not None:
            steps.append(("local", L, "block"))
        dk, dx = np.empty_like(k), np.empty_like(x)
        cnt = max(32, n // _RA_WARPS)
        seg = min(cnt, 2 * L)
        for w in range(_RA_WARPS):
            for o0 in range(w * cnt, min((w + 1) * cnt, n), seg):
                pb = o0 & ~(2 * L - 1)
                _warp_merge(k, x, dk, dx, pb, L, o0 - pb, seg)
        k, x = dk, dx
        L *= 2
    return k, x


def rank_align_model(assignment, group_id, rank, pos_key, cs=16, smem_rows=None):
    """Test-only numpy model of kernel H's schedule (not on any main path),
    on the plan ops/kernels.py rank_align_plan gives for a cluster of `cs`
    CTAs: per sort (by rank, by position) a team of cs / 2 CTAs, the
    `active` ones each sorting its slice in chunks (chunk_sort: 32-row
    bitonic runs, then warp merges a level), then the team's merge levels
    over the chunks, each CTA writing its slice (a warp's max(32, slice /
    32) outputs), and out[order_rank[i]] = assignment[order_pos[i]]. Row
    keys are (group, key) packed into 64 bits, then the index. Returns (out
    [p_max] int32, info: the plan and the steps as (phase, run length,
    barrier))."""
    from .ops.kernels import rank_align_plan

    a = np.asarray(assignment, np.int32)
    p = a.shape[0]
    plan = rank_align_plan(p, cs, smem_rows)
    chunk, sl, active = plan["chunk"], plan["slice"], plan["active"]
    steps = [("runs", 32, "warp")]
    orders = []
    for key in (rank, pos_key):
        keys = _align_keys(group_id, key)
        parts = [_chunk_sort(keys, b, chunk, steps if not orders and b == 0 else None)
                 for b in range(0, p, chunk)]
        k = np.concatenate([q[0] for q in parts])
        x = np.concatenate([q[1] for q in parts])
        cnt = max(32, sl // _RA_WARPS)
        L = chunk
        while L < p:
            if not orders:
                steps.append(("team", L, "cluster"))
            dk, dx = np.empty_like(k), np.empty_like(x)
            seg = min(cnt, 2 * L)
            for m in range(active):
                for w in range(_RA_WARPS):
                    for o0 in range(m * sl + w * cnt, min(m * sl + (w + 1) * cnt, (m + 1) * sl),
                                    seg):
                        pb = o0 & ~(2 * L - 1)
                        _warp_merge(k, x, dk, dx, pb, L, o0 - pb, seg)
            k, x = dk, dx
            L *= 2
        orders.append(x)
    out = np.zeros(p, np.int32)
    out[orders[0]] = a[orders[1]]
    return out, dict(plan=plan, levels=steps)

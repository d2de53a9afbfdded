"""The batch path's per-pod route for the fallback classes
(scheduler/batch.py _serial_one) against the JAX package's, tolerance 0.

Seeded mixed batches (testing.fallback_workload: plain device pods with
pre-bound PVC, WaitForFirstConsumer provisioning and static-match, DRA one-
and two-device, Honor-taints spread, ephemeral-volume and shared-disk pods)
run through BatchScheduler in both packages in the exact, auto and auction
modes at up to 50 nodes: the {pod: node} map, the conditions, the events,
the queue tiers, the counters, the PV/PVC writes, the claim allocations and
the fallback counts must be equal. Also: a fallback pod that fails and
preempts through _maybe_preempt, a gang with a fallback member (vetoed
whole), and the QueueingHint moves on PV, PVC, StorageClass, CSINode,
ResourceClaim, ResourceSlice and DeviceClass events.
"""

from types import SimpleNamespace

import pytest
from test_torch_serial import Env, end_state

import kubernetes_tpu.api.dra as jdra
import kubernetes_tpu.api.storage as jst
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.api.labels import NodeSelector as JNodeSelector
from kubernetes_tpu.api.types import ObjectMeta as JObjectMeta
from kubernetes_tpu.utils.featuregate import feature_gates as jgates
from kubernetes_tpu_torch.utils.featuregate import feature_gates as tgates

KINDS = ("nodes", "csinodes", "storageclasses", "persistentvolumes", "persistentvolumeclaims",
         "deviceclasses", "resourceslices", "resourceclaims")
WRITTEN = ("persistentvolumes", "persistentvolumeclaims", "resourceclaims")
JAX_API = SimpleNamespace(MakeNode=jt.MakeNode, MakePod=jt.MakePod, ObjectMeta=JObjectMeta,
                          NodeSelector=JNodeSelector, storage=jst, dra=jdra)


@pytest.fixture(autouse=True)
def dra_gate():
    for g in (jgates, tgates):
        g.set("DynamicResourceAllocation", True)
    yield
    for g in (jgates, tgates):
        g.set("DynamicResourceAllocation", False)


def workload(env, seed, **kw):
    return tt.fallback_workload(seed, api=None if env.port else JAX_API, **kw)


def setup(env, w):
    for kind in KINDS:
        for obj in w[kind]:
            env.store.create(kind, obj)


def counted(env):
    """Count the per-pod route's binds on the JAX side the way its batch
    does (out["serial_scheduled"]): scheduled_count around _serial_one."""
    if env.port:
        return
    env.serial_scheduled = 0
    inner = env.sched._serial_one

    def serial_one(qp):
        before = env.sched.scheduled_count
        inner(qp)
        env.serial_scheduled += env.sched.scheduled_count - before

    env.sched._serial_one = serial_one


def fallback_counts(env):
    if env.port:
        return env.sched.fallback_pods, env.sched.serial_scheduled
    return (sum(r["fallback"] for r in env.sched.flightrec.records()), env.serial_scheduled)


def writes(env):
    return {kind: sorted(repr(o.to_dict()) for o in env.store.list(kind)[0]) for kind in WRITTEN}


def drive_mixed(env, seed, solver, batch_size=64, **kw):
    w = workload(env, seed, **kw)
    setup(env, w)
    env.batch(solver, batch_size=batch_size)
    counted(env)
    env.store.create_many("pods", w["pods"])
    env.retry(rounds=2)
    return w


SMALL = dict(n_nodes=40, n_device=40, zones=4, tainted=4, slice_every=5, devices_per_slice=2,
             csi_limit=2, prebound=4, provision=3, static=2, dra_one=4, dra_two=3, spread=5,
             ephemeral=1, shared_disk=1)


def check_gates(env, w):
    """What must hold of the end state in either package: every volume pod
    on a node its PV admits, each PV bound once, claims allocated from the
    pod's node and reserved for it, no device in two claims."""
    pods = {p.metadata.name: p for p in env.store.list("pods")[0]}
    nodes = {n.metadata.name: n for n in w["nodes"]}
    pvcs = {c.metadata.name: c for c in env.store.list("persistentvolumeclaims")[0]}
    pvs = {v.metadata.name: v for v in env.store.list("persistentvolumes")[0]}
    claims = {c.metadata.name: c for c in env.store.list("resourceclaims")[0]}
    bound_to = {}
    for name, cls in w["class_of"].items():
        pod = pods[name]
        if not pod.spec.node_name:
            continue
        node = nodes[pod.spec.node_name]
        for v in pod.spec.volumes:
            cn = v.pvc_claim_name or (f"{name}-{v.name}" if v.ephemeral else "")
            if not cn:
                continue
            pvc = pvcs[cn]
            assert pvc.spec.volume_name, (name, cn)
            pv = pvs[pvc.spec.volume_name]
            assert pv.spec.claim_ref == f"default/{cn}"
            assert pv.spec.node_affinity is None or pv.spec.node_affinity.matches(node)
            assert bound_to.setdefault(pv.metadata.name, cn) == cn
        for _ref, cn in pod.spec.resource_claims:
            c = claims[cn]
            assert c.allocation.node_name == pod.spec.node_name and name in c.reserved_for
    used = [f"{c.allocation.node_name}/{d}" for c in claims.values() if c.allocation
            for d in c.allocation.all_devices()]
    assert len(used) == len(set(used))


@pytest.mark.parametrize("solver", ["exact", "auto", "auction"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mixed_batch_matches_jax(solver, seed):
    out = []
    for port in (False, True):
        env = Env(port)
        w = drive_mixed(env, seed, solver, **SMALL)
        check_gates(env, w)
        out.append((end_state(env), writes(env), fallback_counts(env), env))
    (want, want_w, want_c, _), (got, got_w, got_c, tenv) = out
    for key in want:
        assert got[key] == want[key], key
    assert got_w == want_w
    assert got_c == want_c
    fb = [n for n in got["placement"] if n.startswith("fb-")]
    placed = sum(1 for n in fb if got["placement"][n])
    # the classes the configuration can hold are placed; the rest fail with
    # their plugin's own reason, never FALLBACK_REASON
    assert placed >= len(fb) - 3
    assert got_c[0] >= len(fb) and got_c[1] >= placed - 2
    assert all("not yet ported" not in m for m in got["failed"].values())
    assert tenv.sched.stage_seconds["fallback"] > 0


def test_each_fallback_class_lands_where_jax_places_it():
    """One pod of each class alone beside a few device pods, in one batch."""
    classes = dict(prebound=1, provision=1, static=1, dra_one=1, dra_two=1, spread=1,
                   ephemeral=1, shared_disk=1)
    want = got = None
    for port in (False, True):
        env = Env(port)
        w = drive_mixed(env, 3, "auto", n_nodes=20, n_device=6, zones=4, slice_every=4,
                        devices_per_slice=2, **classes)
        check_gates(env, w)
        placement = {n: end_state(env)["placement"][n] for n in w["class_of"]}
        assert all(placement.values()), placement
        if port:
            got = placement, writes(env)
        else:
            want = placement, writes(env)
    assert got == want


def sc_fallback_pod_preempts(env):
    """A priority-100 pod with a pre-bound PVC whose PV admits only zone z0,
    where every node is full of priority-1 pods: the per-pod cycle fails,
    _maybe_preempt nominates a node of z0 and evicts, and the retry binds
    it there."""
    w = workload(env, 5, n_nodes=8, n_device=0, zones=2, prebound=1, provision=0, static=0,
                 dra_one=0, dra_two=0, spread=0)
    setup(env, w)
    for i in range(8):
        env.store.create("pods", env.m.MakePod(f"low-{i}").priority(1).req(
            {"cpu": "7"}).node(f"node-{i}").obj())
    env.batch("auto")
    env.sync_preemption()
    counted(env)
    pod = env.m.MakePod("high").priority(100).req({"cpu": "2"}).pvc("data-0").obj()
    env.store.create("pods", pod)
    env.drive()
    first = end_state(env)
    assert first["nominated"].get("high", "").endswith(("-0", "-2", "-4", "-6"))
    env.retry(rounds=2)
    placed = env.store.get("pods", "default/high").spec.node_name
    assert placed and int(placed.rsplit("-", 1)[1]) % 2 == 0
    return first, writes(env), fallback_counts(env)


def sc_gang_with_fallback_member_vetoed(env):
    """A gang with one PVC member is vetoed whole, with one GangVetoed event,
    in both packages; the fallback member never reaches the per-pod route."""
    w = workload(env, 6, n_nodes=6, n_device=0, zones=2, prebound=1, provision=0, static=0,
                 dra_one=0, dra_two=0, spread=0)
    setup(env, w)
    env.batch("auto")
    counted(env)
    env.store.create("podgroups", env.m.make_pod_group("g", 3))
    pods = [env.m.MakePod(f"g-{i}").gang("g").req({"cpu": "1"}).obj() for i in range(2)]
    pods.append(env.m.MakePod("g-2").gang("g").req({"cpu": "1"}).pvc("data-0").obj())
    env.store.create_many("pods", pods)
    env.drive()
    assert not any(p.spec.node_name for p in env.store.list("pods")[0])
    assert env.sched.gang_vetoes == 1
    return fallback_counts(env)


@pytest.mark.parametrize("scenario", [sc_fallback_pod_preempts, sc_gang_with_fallback_member_vetoed],
                         ids=lambda s: s.__name__)
def test_fallback_scenario_matches_jax(scenario):
    want_env, got_env = Env(False), Env(True)
    want_x, got_x = scenario(want_env), scenario(got_env)
    assert got_x == want_x
    want, got = end_state(want_env), end_state(got_env)
    for key in want:
        assert got[key] == want[key], key


def hint_events(env):
    """Pods rejected by VolumeBinding (a missing PVC), NodeVolumeLimits, and
    DynamicResources (a missing claim at PreEnqueue, no devices at Filter),
    then one cluster event of each storage and DRA kind: after each event,
    which pods left the unschedulable tier. Between events every pod is
    parked again."""
    a = tt.fallback_api() if env.port else JAX_API
    st, dra = a.storage, a.dra
    w = workload(env, 7, n_nodes=4, n_device=0, zones=2, slice_every=100, prebound=0,
                 provision=0, static=0, dra_one=1, dra_two=0, spread=0, csi_limit=0)
    w["resourceslices"] = []
    w["deviceclasses"] = []
    setup(env, w)
    env.batch("auto")
    pods = [env.m.MakePod("no-pvc").req({"cpu": "1"}).pvc("later").obj(),
            env.m.MakePod("no-claim").req({"cpu": "1"}).claim("later-claim").obj(),
            env.m.MakePod("no-device").req({"cpu": "1"}).claim("claim-0").obj(),
            env.m.MakePod("too-big").req({"cpu": "64"}).obj()]
    env.store.create_many("pods", pods)
    env.drive()

    def unsched():
        return sorted((qp.pod.metadata.name, tuple(qp.unschedulable_plugins))
                      for qp in env.sched.queue._unschedulable.values())

    rows = [("start", unsched())]
    zone_sel = a.NodeSelector.from_dict({"nodeSelectorTerms": [{"matchExpressions": [
        {"key": "topology.kubernetes.io/zone", "operator": "In", "values": ["z0"]}]}]})
    sc = st.StorageClass(metadata=a.ObjectMeta(name="extra"), provisioner="x",
                         volume_binding_mode=st.BINDING_WAIT_FOR_FIRST_CONSUMER,
                         allowed_topologies=zone_sel)
    pv = st.PersistentVolume(metadata=a.ObjectMeta(name="pv-extra"))
    pvc = st.PersistentVolumeClaim(metadata=a.ObjectMeta(name="unrelated"))
    other_claim = dra.ResourceClaim(metadata=a.ObjectMeta(name="other"))
    steps = [
        ("storageclasses", "create", sc),
        ("persistentvolumes", "create", pv),
        ("persistentvolumeclaims", "create", pvc),
        ("csinodes", "update", None),
        ("resourceclaims", "create", other_claim),
        ("deviceclasses", "create", dra.DeviceClass(metadata=a.ObjectMeta(
            name=tt.FALLBACK_DEVICE_CLASS, namespace=""))),
        ("resourceslices", "create", dra.ResourceSlice(
            metadata=a.ObjectMeta(name="s", namespace=""), node_name="node-1",
            devices=[dra.Device(name="gpu-0", attributes={"type": "gpu"})])),
        ("resourceclaims", "create", dra.ResourceClaim(metadata=a.ObjectMeta(
            name="later-claim"))),
        ("resourceclaims", "delete", "default/other"),
        ("persistentvolumeclaims", "create", st.PersistentVolumeClaim(
            metadata=a.ObjectMeta(name="later"))),
    ]
    for kind, op, obj in steps:
        if op == "create":
            env.store.create(kind, obj)
        elif op == "delete":
            env.store.delete(kind, obj)
        else:
            cur = env.store.get(kind, "node-0")
            cur.drivers = {tt.FALLBACK_DRIVER: 5}
            env.store.update(kind, cur)
        env.sched.pump_events()
        rows.append((kind, op, unsched(), tuple(env.sched.queue.lengths())))
        env.clock.step(11)
        env.sched.queue.flush_backoff_completed()
        env.drive()
    return rows


def test_hint_moves_on_storage_and_dra_events_match_jax():
    want_env, got_env = Env(False), Env(True)
    want, got = hint_events(want_env), hint_events(got_env)
    assert got == want
    # the missing-PVC pod waits on VolumeBinding, the missing claim on
    # DynamicResources' PreEnqueue
    start = dict(got[0][1])
    assert start["no-pvc"] == ("VolumeBinding",)
    assert start["no-claim"] == ("DynamicResources",)
    assert start["too-big"] == ("NodeResourcesFit",)
    # a storage event moves the VolumeBinding pod and none of the others
    moved_by_sc = {n for n, _ in got[0][1]} - {n for n, _ in got[1][2]}
    assert moved_by_sc == {"no-pvc"}

"""The port's volume plugins (scheduler/plugins/volume.py: VolumeBinding,
VolumeRestrictions, VolumeZone, NodeVolumeLimits), storage API types
(api/storage.py), store kinds and scheduler wiring against the JAX
package's, tolerance 0.

Every case of tests/test_volume.py runs in both packages on identical
objects: the statuses (code, reasons, plugin), the scores, the PV/PVC
writes, and for the end-to-end cases the {pod: node} map, the conditions,
the events, the queue tiers and the counters must be equal. Each case also
asserts the reference test's own expectation, so two packages that are
wrong the same way still fail.
"""

import pytest
from test_torch_serial import Env, end_state

import kubernetes_tpu.api.storage as jst
import kubernetes_tpu.scheduler.framework as jfw
import kubernetes_tpu.scheduler.plugins as jpl
import kubernetes_tpu.snapshot.tensorizer as jtz
import kubernetes_tpu.testing as jt
import kubernetes_tpu_torch.api.storage as tst
import kubernetes_tpu_torch.scheduler.framework as tfw
import kubernetes_tpu_torch.scheduler.plugins as tpl
import kubernetes_tpu_torch.snapshot.tensorizer as ttz
import kubernetes_tpu_torch.testing as tt
from kubernetes_tpu.api import labels as jlb
from kubernetes_tpu.api import types as jty
from kubernetes_tpu.scheduler.cache import Cache as JCache
from kubernetes_tpu.utils import FakeClock as JFakeClock
from kubernetes_tpu_torch.api import labels as tlb
from kubernetes_tpu_torch.api import types as tty
from kubernetes_tpu_torch.scheduler.cache import Cache as TCache

STORAGE_KINDS = ("persistentvolumes", "persistentvolumeclaims", "storageclasses", "csinodes")


class Pkg:
    """One package's modules, with the reference test's object builders."""

    def __init__(self, port: bool):
        self.port = port
        self.st = tst if port else jst
        self.fw = tfw if port else jfw
        self.pl = tpl if port else jpl
        self.m = tt if port else jt
        self.lb = tlb if port else jlb
        self.ty = tty if port else jty
        self.tz = ttz if port else jtz

    def pvc(self, name, request=100, modes=("ReadWriteOnce",), sc="std", volume="",
            ns="default", phase=None):
        pvc = self.st.PersistentVolumeClaim(metadata=self.ty.ObjectMeta(name=name, namespace=ns))
        pvc.spec.access_modes = list(modes)
        pvc.spec.request = request
        pvc.spec.storage_class_name = sc
        pvc.spec.volume_name = volume
        pvc.phase = phase or (self.st.CLAIM_BOUND if volume else "Pending")
        return pvc

    def pv(self, name, capacity=100, modes=("ReadWriteOnce",), sc="std", zone=None,
           node_affinity=None, claim_ref="", csi_driver=""):
        pv = self.st.PersistentVolume(metadata=self.ty.ObjectMeta(name=name))
        pv.spec.capacity = capacity
        pv.spec.access_modes = list(modes)
        pv.spec.storage_class_name = sc
        pv.spec.claim_ref = claim_ref
        pv.spec.csi_driver = csi_driver
        if claim_ref:
            pv.phase = self.st.VOLUME_BOUND
        if zone:
            pv.metadata.labels["topology.kubernetes.io/zone"] = zone
        if node_affinity:
            key, values = node_affinity
            pv.spec.node_affinity = self.selector(key, values)
        return pv

    def selector(self, key, values):
        return self.lb.NodeSelector.from_dict({"nodeSelectorTerms": [
            {"matchExpressions": [{"key": key, "operator": "In", "values": values}]}]})

    def sclass(self, name, mode=jst.BINDING_WAIT_FOR_FIRST_CONSUMER,
               provisioner="csi.example.com", topo=None):
        sc = self.st.StorageClass(metadata=self.ty.ObjectMeta(name=name))
        sc.provisioner = provisioner
        sc.volume_binding_mode = mode
        if topo:
            sc.allowed_topologies = self.selector(*topo)
        return sc

    def node_info(self, node, pods=()):
        ni = self.fw.NodeInfo(node)
        for p in pods:
            ni.add_pod(self.fw.PodInfo(p))
        return ni

    def snap_of(self, *nis):
        return self.fw.Snapshot({ni.node.metadata.name: ni for ni in nis})

    def run(self, plugin, pod, ni, snap=None):
        """PreFilter (when the plugin has one) then Filter, as the reference
        test's run()."""
        state = self.fw.CycleState()
        snap = snap or self.snap_of(ni)
        state.write("Snapshot", snap)
        if hasattr(plugin, "pre_filter"):
            _, st = plugin.pre_filter(state, pod, snap)
            if not st.is_success() and not st.is_skip():
                return state, st
        return state, plugin.filter(state, pod, ni)


def status(st):
    return (st.code.name, tuple(st.reasons), st.plugin)


def lister_dump(lister):
    return {"pvcs": sorted((k, repr(v.to_dict())) for k, v in lister.pvcs.items()),
            "pvs": sorted((k, repr(v.to_dict())) for k, v in lister.pvs.items())}


def store_dump(store):
    return {kind: sorted(repr(o.to_dict()) for o in store.list(kind)[0])
            for kind in STORAGE_KINDS}


# -- VolumeBinding -------------------------------------------------------------


def vb_no_volumes_skips(k):
    plugin = k.pl.VolumeBinding(k.pl.VolumeLister())
    _, st = plugin.pre_filter(k.fw.CycleState(), k.m.MakePod().obj(), k.snap_of())
    assert st.is_skip()
    return status(st)


def vb_missing_pvc_unresolvable(k):
    plugin = k.pl.VolumeBinding(k.pl.VolumeLister())
    _, st = plugin.pre_filter(k.fw.CycleState(), k.m.MakePod().pvc("missing").obj(),
                              k.snap_of())
    assert st.is_rejected() and "not found" in st.message()
    return status(st)


def vb_unbound_immediate_rejected(k):
    lister = k.pl.VolumeLister()
    lister.add(k.sclass("std", mode=k.st.BINDING_IMMEDIATE))
    lister.add(k.pvc("claim", sc="std"))
    plugin = k.pl.VolumeBinding(lister)
    _, st = plugin.pre_filter(k.fw.CycleState(), k.m.MakePod().pvc("claim").obj(), k.snap_of())
    assert st.is_rejected() and "unbound immediate" in st.message()
    return status(st)


def vb_bound_pv_node_affinity(k):
    lister = k.pl.VolumeLister()
    lister.add(k.pv("pv1", node_affinity=("zone", ["a"]), claim_ref="default/claim"))
    lister.add(k.pvc("claim", volume="pv1"))
    plugin = k.pl.VolumeBinding(lister)
    pod = k.m.MakePod().pvc("claim").obj()
    good = k.node_info(k.m.MakeNode("n1").labels({"zone": "a"}).obj())
    bad = k.node_info(k.m.MakeNode("n2").labels({"zone": "b"}).obj())
    ok = k.run(plugin, pod, good)[1]
    _, st = k.run(plugin, pod, bad)
    assert ok.is_success() and st.is_rejected() and "affinity conflict" in st.message()
    return status(ok), status(st)


def vb_wfc_static_binding_and_prebind(k):
    lister = k.pl.VolumeLister()
    lister.add(k.sclass("std"))
    lister.add(k.pv("pv-small", capacity=50, node_affinity=("zone", ["a"])))
    lister.add(k.pv("pv-big", capacity=500, node_affinity=("zone", ["a"])))
    pvc = k.pvc("claim", request=40)
    lister.add(pvc)
    plugin = k.pl.VolumeBinding(lister)
    pod = k.m.MakePod().pvc("claim").obj()
    ni = k.node_info(k.m.MakeNode("n1").labels({"zone": "a"}).obj())
    state, st = k.run(plugin, pod, ni)
    out = [status(st), status(plugin.reserve(state, pod, "n1")),
           status(plugin.pre_bind(state, pod, "n1"))]
    # smallest fitting PV chosen, binding committed both ways
    assert pvc.spec.volume_name == "pv-small" and pvc.phase == k.st.CLAIM_BOUND
    assert lister.pvs["pv-small"].spec.claim_ref == "default/claim"
    return out, lister_dump(lister)


def vb_wfc_no_pv_no_class_topology_rejected(k):
    lister = k.pl.VolumeLister()
    lister.add(k.sclass("std", topo=("zone", ["a"])))
    lister.add(k.pvc("claim"))
    plugin = k.pl.VolumeBinding(lister)
    ni_bad = k.node_info(k.m.MakeNode("n2").labels({"zone": "b"}).obj())
    _, st = k.run(plugin, k.m.MakePod().pvc("claim").obj(), ni_bad)
    assert st.is_rejected()
    return status(st)


def vb_wfc_provisioning_creates_pv(k):
    lister = k.pl.VolumeLister()
    lister.add(k.sclass("std", topo=("zone", ["a"])))
    pvc = k.pvc("claim", request=77)
    lister.add(pvc)
    plugin = k.pl.VolumeBinding(lister)
    pod = k.m.MakePod().pvc("claim").obj()
    ni = k.node_info(k.m.MakeNode("n1").labels({"zone": "a"}).obj())
    state, st = k.run(plugin, pod, ni)
    out = [status(st), status(plugin.reserve(state, pod, "n1")),
           status(plugin.pre_bind(state, pod, "n1"))]
    assert pvc.spec.volume_name and pvc.phase == k.st.CLAIM_BOUND
    assert lister.pvs[pvc.spec.volume_name].spec.capacity == 77
    return out, lister_dump(lister)


def vb_score_prefers_tight_fit(k):
    lister = k.pl.VolumeLister()
    lister.add(k.sclass("std"))
    lister.add(k.pv("pv-tight", capacity=100, node_affinity=("h", ["n1"])))
    lister.add(k.pv("pv-loose", capacity=1000, node_affinity=("h", ["n2"])))
    lister.add(k.pvc("claim", request=90))
    plugin = k.pl.VolumeBinding(lister)
    pod = k.m.MakePod().pvc("claim").obj()
    ni1 = k.node_info(k.m.MakeNode("n1").labels({"h": "n1"}).obj())
    ni2 = k.node_info(k.m.MakeNode("n2").labels({"h": "n2"}).obj())
    state, st = k.run(plugin, pod, ni1, k.snap_of(ni1, ni2))
    s1, st1 = plugin.score(state, pod, ni1)
    s2, st2 = plugin.score(state, pod, ni2)
    assert st.is_success() and s1 > s2
    return status(st), (s1, status(st1)), (s2, status(st2))


# -- VolumeRestrictions ----------------------------------------------------------


def vr_gce_pd_conflict(k):
    existing = k.m.MakePod("other").volume(gce_pd="disk1").obj()
    ni = k.node_info(k.m.MakeNode("n1").obj(), [existing])
    _, st = k.run(k.pl.VolumeRestrictions(), k.m.MakePod().volume(gce_pd="disk1").obj(), ni)
    assert st.is_rejected()
    return status(st)


def vr_gce_pd_both_read_only_ok(k):
    existing = k.m.MakePod("other").volume(gce_pd="disk1", gce_read_only=True).obj()
    ni = k.node_info(k.m.MakeNode("n1").obj(), [existing])
    pod = k.m.MakePod().volume(gce_pd="disk1", gce_read_only=True).obj()
    _, st = k.run(k.pl.VolumeRestrictions(), pod, ni)
    assert st.is_success()
    return status(st)


def vr_ebs_always_conflicts(k):
    existing = k.m.MakePod("other").volume(aws_ebs="vol-1").obj()
    ni = k.node_info(k.m.MakeNode("n1").obj(), [existing])
    _, st = k.run(k.pl.VolumeRestrictions(), k.m.MakePod().volume(aws_ebs="vol-1").obj(), ni)
    assert st.is_rejected()
    return status(st)


def vr_rwop_conflict_cluster_wide(k):
    lister = k.pl.VolumeLister()
    lister.add(k.pvc("claim", modes=(k.st.READ_WRITE_ONCE_POD,), volume="pv1"))
    plugin = k.pl.VolumeRestrictions(lister)
    user = k.m.MakePod("user").pvc("claim").obj()
    other_node = k.node_info(k.m.MakeNode("n2").obj(), [user])
    this_node = k.node_info(k.m.MakeNode("n1").obj())
    pod = k.m.MakePod("newpod").pvc("claim").obj()
    _, st = k.run(plugin, pod, this_node, k.snap_of(this_node, other_node))
    assert st.is_rejected() and "ReadWriteOncePod" in st.message()
    return status(st)


# -- VolumeZone ------------------------------------------------------------------


def vz_zone_conflict(k):
    lister = k.pl.VolumeLister()
    lister.add(k.pvc("claim", volume="pv1"))
    lister.add(k.pv("pv1", zone="us-a", claim_ref="default/claim"))
    plugin = k.pl.VolumeZone(lister)
    pod = k.m.MakePod().pvc("claim").obj()
    good = k.node_info(k.m.MakeNode("n1").labels({"topology.kubernetes.io/zone": "us-a"}).obj())
    bad = k.node_info(k.m.MakeNode("n2").labels({"topology.kubernetes.io/zone": "us-b"}).obj())
    ok = k.run(plugin, pod, good)[1]
    st = k.run(plugin, pod, bad)[1]
    assert ok.is_success() and st.is_rejected()
    return status(ok), status(st)


def vz_multi_zone_pv_label(k):
    lister = k.pl.VolumeLister()
    lister.add(k.pvc("claim", volume="pv1"))
    lister.add(k.pv("pv1", zone="us-a__us-b", claim_ref="default/claim"))
    plugin = k.pl.VolumeZone(lister)
    ni = k.node_info(k.m.MakeNode("n1").labels({"topology.kubernetes.io/zone": "us-b"}).obj())
    _, st = k.run(plugin, k.m.MakePod().pvc("claim").obj(), ni)
    assert st.is_success()
    return status(st)


# -- NodeVolumeLimits ------------------------------------------------------------


def _limits_lister(k, limit=2):
    lister = k.pl.VolumeLister()
    lister.add(k.st.CSINode(metadata=k.ty.ObjectMeta(name="n1"),
                            drivers={"csi.example.com": limit}))
    for i in range(3):
        lister.add(k.pvc(f"claim{i}", volume=f"pv{i}"))
        lister.add(k.pv(f"pv{i}", csi_driver="csi.example.com", claim_ref=f"default/claim{i}"))
    return lister


def nvl_under_limit(k):
    plugin = k.pl.NodeVolumeLimits(_limits_lister(k, limit=2))
    ni = k.node_info(k.m.MakeNode("n1").obj(), [k.m.MakePod("other").pvc("claim0").obj()])
    _, st = k.run(plugin, k.m.MakePod().pvc("claim1").obj(), ni)
    assert st.is_success()
    return status(st)


def nvl_over_limit(k):
    plugin = k.pl.NodeVolumeLimits(_limits_lister(k, limit=2))
    ni = k.node_info(k.m.MakeNode("n1").obj(), [k.m.MakePod("a").pvc("claim0").obj(),
                                                k.m.MakePod("b").pvc("claim1").obj()])
    _, st = k.run(plugin, k.m.MakePod().pvc("claim2").obj(), ni)
    assert st.is_rejected() and "max volume count" in st.message()
    return status(st)


def nvl_nil_allocatable_count_means_no_limit(k):
    lister = _limits_lister(k, limit=2)
    csinode = k.st.CSINode.from_dict({"metadata": {"name": "n1"},
                                      "spec": {"drivers": [{"name": "csi.example.com"}]}})
    assert csinode.drivers == {"csi.example.com": None}
    assert k.st.CSINode.from_dict(csinode.to_dict()).drivers == csinode.drivers
    lister.csinodes["n1"] = csinode
    plugin = k.pl.NodeVolumeLimits(lister)
    ni = k.node_info(k.m.MakeNode("n1").obj(), [k.m.MakePod("a").pvc("claim0").obj(),
                                                k.m.MakePod("b").pvc("claim1").obj()])
    _, st = k.run(plugin, k.m.MakePod().pvc("claim2").obj(), ni)
    assert st.is_success()
    return status(st), repr(csinode.to_dict())


def nvl_no_csinode_no_limit(k):
    lister = _limits_lister(k, limit=0)
    lister.csinodes.clear()
    plugin = k.pl.NodeVolumeLimits(lister)
    ni = k.node_info(k.m.MakeNode("n1").obj(), [k.m.MakePod("a").pvc("claim0").obj()])
    _, st = k.run(plugin, k.m.MakePod().pvc("claim1").obj(), ni)
    assert st.is_success()
    return status(st)


# -- types, matching, tensorizer routing -----------------------------------------


def pv_node_affinity_roundtrip(k):
    pv = k.pv("pv1", node_affinity=("zone", ["a", "b"]))
    pv2 = k.st.PersistentVolume.from_dict(pv.to_dict())
    assert pv2.spec.node_affinity is not None and pv2.to_dict() == pv.to_dict()
    assert pv2.spec.node_affinity.matches(k.m.MakeNode("n1").labels({"zone": "a"}).obj())
    assert not pv2.spec.node_affinity.matches(k.m.MakeNode("n2").labels({"zone": "c"}).obj())
    pvc = k.pvc("claim", request=5, volume="pv1")
    sc = k.sclass("std", topo=("zone", ["a"]))
    return [repr(o.to_dict()) for o in (pv2, k.st.PersistentVolumeClaim.from_dict(pvc.to_dict()),
                                        k.st.StorageClass.from_dict(sc.to_dict()))]


def default_class_resolution_in_matching(k):
    """A PVC without an explicit class matches only PVs of the cluster
    default class (volume_binding.go findMatchingVolumes)."""
    lister = k.pl.VolumeLister()
    default_sc = k.sclass("fast")
    default_sc.is_default = True
    lister.add(default_sc)
    lister.add(k.sclass("slow"))
    lister.add(k.pv("pv-slow", sc="slow"))
    lister.add(k.pvc("claim", sc=None))
    plugin = k.pl.VolumeBinding(lister)
    pod = k.m.MakePod().pvc("claim").obj()
    ni = k.node_info(k.m.MakeNode("n1").obj())
    _, st = k.run(plugin, pod, ni)
    assert st.is_success()
    state = k.fw.CycleState()
    snap = k.snap_of(ni)
    state.write("Snapshot", snap)
    plugin.pre_filter(state, pod, snap)
    binding, _ = plugin._node_binding(state, pod, ni.node)
    assert not binding.static and len(binding.provision) == 1
    return status(st), [p.key for p in binding.provision]


def _fallback_mask(k, pods, nodes):
    cache = TCache() if k.port else JCache(clock=JFakeClock())
    for n in nodes:
        cache.add_node(n)
    snap = cache.update_snapshot()
    if k.port:
        cluster, _ = ttz.TensorCache().cluster_tensors(snap)
    else:
        cluster = jtz.build_cluster_tensors(snap)
    batch = k.tz.build_pod_batch(pods, snap, cluster)
    return [bool(x) for x in batch.fallback_class[batch.class_of_pod]]


def batch_routes_volume_pods_to_serial(k):
    nodes = [k.m.MakeNode(n).capacity({"cpu": "4", "memory": "8Gi", "pods": "10"}).obj()
             for n in ("n1", "n2")]
    pods = [k.m.MakePod("vol").req({"cpu": "1"}).pvc("claim").obj(),
            k.m.MakePod("plain").req({"cpu": "1"}).obj()]
    mask = _fallback_mask(k, pods, nodes)
    assert mask == [True, False]
    return mask


def config_volumes_stay_on_device(k):
    """configMap/secret/emptyDir volumes never constrain placement; pods
    carrying only those take the device path."""
    nodes = [k.m.MakeNode("n1").capacity({"cpu": "4"}).obj()]
    V = k.ty.Volume
    pod = k.m.MakePod("cfgpod").req({"cpu": "1"}).obj()
    pod.spec.volumes = [V.from_dict({"name": "cfg", "configMap": {"name": "app-config"}}),
                        V.from_dict({"name": "creds", "secret": {"secretName": "s"}}),
                        V.from_dict({"name": "scratch", "emptyDir": {}})]
    ephemeral = k.m.MakePod("eph").req({"cpu": "1"}).volume(name="data", ephemeral=True).obj()
    mask = _fallback_mask(k, [pod, ephemeral], nodes)
    assert mask == [False, True]
    return mask


def volume_from_dict_read_only_flags(k):
    d = {"name": "v", "persistentVolumeClaim": {"claimName": "c", "readOnly": True}}
    vols = [k.ty.Volume.from_dict(d),
            k.ty.Volume.from_dict({"name": "g", "gcePersistentDisk": {"pdName": "d",
                                                                        "readOnly": True}}),
            k.ty.Volume.from_dict({"name": "r", "rbd": {"image": "i", "readOnly": True}}),
            k.ty.Volume.from_dict({"name": "s", "iscsi": {"iqn": "q", "lun": 2,
                                                            "readOnly": True}})]
    keys = ("name", "pvc_claim_name", "pvc_read_only", "gce_pd", "gce_read_only", "rbd",
            "rbd_read_only", "iscsi", "iscsi_read_only", "scheduling_relevant")
    return [tuple(getattr(v, f) for f in keys) for v in vols]


UNIT_CASES = [vb_no_volumes_skips, vb_missing_pvc_unresolvable, vb_unbound_immediate_rejected,
              vb_bound_pv_node_affinity, vb_wfc_static_binding_and_prebind,
              vb_wfc_no_pv_no_class_topology_rejected, vb_wfc_provisioning_creates_pv,
              vb_score_prefers_tight_fit, vr_gce_pd_conflict, vr_gce_pd_both_read_only_ok,
              vr_ebs_always_conflicts, vr_rwop_conflict_cluster_wide, vz_zone_conflict,
              vz_multi_zone_pv_label, nvl_under_limit, nvl_over_limit,
              nvl_nil_allocatable_count_means_no_limit, nvl_no_csinode_no_limit,
              pv_node_affinity_roundtrip, default_class_resolution_in_matching,
              batch_routes_volume_pods_to_serial, config_volumes_stay_on_device,
              volume_from_dict_read_only_flags]


@pytest.mark.parametrize("case", UNIT_CASES, ids=lambda c: c.__name__)
def test_volume_plugin_case_matches_jax(case):
    assert case(Pkg(True)) == case(Pkg(False))


# -- the store, the serial scheduler and the batch path --------------------------


def e2e_scheduler_feeds_lister_and_persists_binding(env):
    """Storage objects created in the store reach the plugins' lister via
    sync(), and PreBind writes the PVC/PV binding back to the store."""
    k = Pkg(env.port)
    env.store.create("nodes", k.m.MakeNode("n1").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "10"}).obj())
    env.store.create("storageclasses", k.sclass("std"))
    env.store.create("persistentvolumeclaims", k.pvc("claim", request=10))
    env.store.create("persistentvolumes", k.pv(
        "pv1", capacity=20, node_affinity=("kubernetes.io/hostname", ["n1"])))
    env.store.create("pods", k.m.MakePod("p").req({"cpu": "1"}).pvc("claim").obj())
    env.serial()
    assert env.sched.schedule_one()
    assert env.store.get("pods", "default/p").spec.node_name == "n1"
    pvc = env.store.get("persistentvolumeclaims", "default/claim")
    assert pvc.spec.volume_name == "pv1" and pvc.phase == k.st.CLAIM_BOUND
    assert env.store.get("persistentvolumes", "pv1").spec.claim_ref == "default/claim"
    return store_dump(env.store)


def e2e_pv_created_after_sync_unblocks_pod(env):
    k = Pkg(env.port)
    env.store.create("nodes", k.m.MakeNode("n1").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "10"}).obj())
    env.store.create("storageclasses", k.sclass("std", provisioner=""))
    env.store.create("persistentvolumeclaims", k.pvc("claim", request=10))
    env.store.create("pods", k.m.MakePod("p").req({"cpu": "1"}).pvc("claim").obj())
    env.serial()
    env.sched.schedule_one()  # no PV, no provisioner: unschedulable
    assert env.store.get("pods", "default/p").spec.node_name == ""
    first = end_state(env)
    env.store.create("persistentvolumes", k.pv("pv1", capacity=20))
    env.sched.pump_events()
    env.clock.step(11)  # past max backoff so the requeued pod pops
    env.sched.queue.flush_backoff_completed()
    assert env.sched.schedule_one()
    assert env.store.get("pods", "default/p").spec.node_name == "n1"
    return first, store_dump(env.store)


def e2e_batch_scheduler_commits_volume_binding(env):
    """Through BatchScheduler: the volume pod takes the per-pod route and its
    PVC/PV binding is committed via Reserve/PreBind."""
    k = Pkg(env.port)
    for name in ("n1", "n2"):
        env.store.create("nodes", k.m.MakeNode(name).capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "20"}).obj())
    env.store.create("storageclasses", k.sclass("std"))
    env.store.create("persistentvolumeclaims", k.pvc("claim", request=10))
    env.store.create("persistentvolumes", k.pv(
        "pv1", capacity=20, node_affinity=("kubernetes.io/hostname", ["n2"])))
    env.store.create("pods", k.m.MakePod("vol").req({"cpu": "1"}).pvc("claim").obj())
    for i in range(4):
        env.store.create("pods", k.m.MakePod(f"plain-{i}").req({"cpu": "1"}).obj())
    env.batch("exact")
    env.drive()
    assert env.store.get("pods", "default/vol").spec.node_name == "n2"
    pvc = env.store.get("persistentvolumeclaims", "default/claim")
    assert pvc.spec.volume_name == "pv1" and pvc.phase == k.st.CLAIM_BOUND
    assert env.store.get("persistentvolumes", "pv1").spec.claim_ref == "default/claim"
    for i in range(4):
        assert env.store.get("pods", f"default/plain-{i}").spec.node_name
    return store_dump(env.store)


def e2e_serial_scheduler_binds_wfc_claim(env):
    """A lister handed to default_plugins (not fed from the store): the
    binding lands in the lister's objects."""
    k = Pkg(env.port)
    lister = k.pl.VolumeLister()
    lister.add(k.sclass("std"))
    pvc = k.pvc("claim", request=10)
    lister.add(pvc)
    lister.add(k.pv("pv1", capacity=20, node_affinity=("kubernetes.io/hostname", ["n1"])))
    for name in ("n1", "n2"):
        env.store.create("nodes", k.m.MakeNode(name).capacity(
            {"cpu": "4", "memory": "8Gi", "pods": "10"}).obj())
    env.store.create("pods", k.m.MakePod("p").req({"cpu": "1"}).pvc("claim").obj())
    env.serial(profiles={"default-scheduler": env.framework(
        k.pl.default_plugins(volume_lister=lister))})
    assert env.sched.schedule_one()
    assert env.store.get("pods", "default/p").spec.node_name == "n1"
    assert pvc.spec.volume_name == "pv1" and pvc.phase == k.st.CLAIM_BOUND
    return lister_dump(lister), store_dump(env.store)


def e2e_storage_events_update_the_lister(env):
    """PV/PVC/StorageClass/CSINode events keep the shared lister current
    (add, update, delete), and a relist rebuilds it from the store."""
    k = Pkg(env.port)
    env.store.create("nodes", k.m.MakeNode("n1").capacity({"cpu": "4"}).obj())
    env.serial()
    env.store.create("storageclasses", k.sclass("std"))
    env.store.create("persistentvolumes", k.pv("pv1", capacity=20))
    env.store.create("persistentvolumeclaims", k.pvc("claim", request=10))
    env.store.create("csinodes", k.st.CSINode(metadata=k.ty.ObjectMeta(name="n1"),
                                              drivers={"csi.example.com": 3}))
    env.sched.pump_events()
    pv = env.store.get("persistentvolumes", "pv1")
    pv.spec.capacity = 30
    env.store.update("persistentvolumes", pv)
    env.store.delete("persistentvolumeclaims", "default/claim")
    env.sched.pump_events()
    lister = env.sched._volume_listers[0]
    assert len(env.sched._volume_listers) == 1
    assert lister.pvs["pv1"].spec.capacity == 30 and not lister.pvcs
    before = lister_dump(lister)
    env.sched._rebuild_from_store(preserve_queue=True)
    assert lister_dump(lister) == before
    return before, sorted(lister.classes), sorted(lister.csinodes)


E2E_CASES = [e2e_scheduler_feeds_lister_and_persists_binding,
             e2e_pv_created_after_sync_unblocks_pod, e2e_batch_scheduler_commits_volume_binding,
             e2e_serial_scheduler_binds_wfc_claim, e2e_storage_events_update_the_lister]


@pytest.mark.parametrize("case", E2E_CASES, ids=lambda c: c.__name__)
def test_volume_end_to_end_matches_jax(case):
    want_env, got_env = Env(False), Env(True)
    want_x, got_x = case(want_env), case(got_env)
    assert got_x == want_x
    want, got = end_state(want_env), end_state(got_env)
    for key in want:
        assert got[key] == want[key], key


def test_store_stores_the_storage_kinds_and_update_check_rv():
    """The storage and DRA kinds are stored; update(check_rv=False) writes
    over a stale resource version as the JAX store's does; any other kind
    lists empty, as in the JAX store."""
    from kubernetes_tpu.store import APIStore as JStore
    from kubernetes_tpu.store import ConflictError as JConflict
    from kubernetes_tpu_torch.store import APIStore as TStore
    from kubernetes_tpu_torch.store import ConflictError as TConflict

    out = []
    for port in (False, True):
        k = Pkg(port)
        store = TStore() if port else JStore()
        conflict = TConflict if port else JConflict
        store.create("persistentvolumes", k.pv("pv1"))
        stale = store.get("persistentvolumes", "pv1")
        store.update("persistentvolumes", store.get("persistentvolumes", "pv1"))
        with pytest.raises(conflict):
            store.update("persistentvolumes", stale)
        stale.spec.capacity = 7
        store.update("persistentvolumes", stale, check_rv=False)
        got = store.get("persistentvolumes", "pv1")
        out.append((got.spec.capacity, got.metadata.resource_version))
    assert out[0] == out[1] == (7, 3)
    for kind in ("resourceclaims", "resourceslices", "deviceclasses", "csinodes",
                 "storageclasses", "persistentvolumeclaims"):
        assert TStore().list(kind)[0] == []
    # any other kind is stored too, as in the JAX store (the lean store
    # raised here): an unwritten kind lists empty at the store's RV
    assert TStore().list("volumeattachments") == JStore().list("volumeattachments") == ([], 0)

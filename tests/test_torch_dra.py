"""The port's DynamicResources plugin (scheduler/plugins/dynamic_resources.py),
DRA API types (api/dra.py) and the DynamicResourceAllocation gate against
the JAX package's, tolerance 0.

The cases of tests/test_dra.py run in both packages on identical stores
under fake clocks: the {pod: node} map, the conditions, the events, the
queue tiers, the counters and the ResourceClaims' allocations and
reservedFor must be equal. Each case also asserts the reference test's own
expectation. The gate is on in both packages for every case here.
"""

import pytest
from test_torch_serial import Env, end_state

import kubernetes_tpu.api.dra as jdra
import kubernetes_tpu.api.types as jty
import kubernetes_tpu.scheduler.plugins as jpl
import kubernetes_tpu_torch.api.dra as tdra
import kubernetes_tpu_torch.api.types as tty
import kubernetes_tpu_torch.scheduler.plugins as tpl
from kubernetes_tpu.scheduler.plugins.dynamic_resources import DynamicResources as JDR
from kubernetes_tpu.utils.featuregate import feature_gates as jgates
from kubernetes_tpu_torch.scheduler.plugins.dynamic_resources import DynamicResources as TDR
from kubernetes_tpu_torch.utils.featuregate import feature_gates as tgates


@pytest.fixture(autouse=True)
def dra_gate():
    for g in (jgates, tgates):
        g.set("DynamicResourceAllocation", True)
    yield
    for g in (jgates, tgates):
        g.set("DynamicResourceAllocation", False)


class Dra:
    """One package's DRA builders (tests/test_dra.py's helpers)."""

    def __init__(self, port: bool):
        self.d = tdra if port else jdra
        self.ty = tty if port else jty
        self.pl = tpl if port else jpl
        self.plugin_cls = TDR if port else JDR

    def slice(self, node, devices, driver="tpu.driver", pool="pool0", mem=16, name=None):
        return self.d.ResourceSlice(
            metadata=self.ty.ObjectMeta(name=name or f"{node}-slice", namespace=""),
            node_name=node, driver=driver, pool=pool,
            devices=[self.d.Device(name=dv, attributes={"type": "tpu", "memGiB": mem})
                     for dv in devices])

    def dclass(self, name="tpu-v5"):
        return self.d.DeviceClass(
            metadata=self.ty.ObjectMeta(name=name, namespace=""),
            selectors=[self.d.DeviceAttributeRequirement(key="type", op="==", value="tpu")])

    def claim(self, name, count=1, class_name="tpu-v5", ns="default", selectors=()):
        return self.d.ResourceClaim(
            metadata=self.ty.ObjectMeta(name=name, namespace=ns),
            requests=[self.d.DeviceRequest(name="dev", device_class_name=class_name,
                                           count=count, selectors=list(selectors))])


def cluster(env, n_nodes=3, devices_per_node=2):
    k = Dra(env.port)
    for i in range(n_nodes):
        env.store.create("nodes", env.m.MakeNode(f"n{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "20"}).obj())
    env.store.create("deviceclasses", k.dclass())
    # only node n1 carries devices
    env.store.create("resourceslices", k.slice("n1", [f"dev-{j}" for j in range(devices_per_node)]))
    return k


def claims(env):
    return sorted(repr(c.to_dict()) for c in env.store.list("resourceclaims")[0])


def node_of(env, name):
    return env.store.get("pods", f"default/{name}").spec.node_name


def retry(env):
    """Past every backoff and the unschedulable flush window, then drive."""
    env.sched.pump_events()
    env.clock.step(61)
    env.sched.queue.flush_backoff_completed()
    env.sched.queue.flush_unschedulable_left_over()
    env.drive()


def sc_claiming_pod_lands_only_on_device_node(env):
    k = cluster(env)
    env.store.create("resourceclaims", k.claim("c1"))
    env.serial()
    env.store.create("pods", env.m.MakePod("p").req({"cpu": "1"}).claim("c1").obj())
    env.drive()
    assert node_of(env, "p") == "n1"
    c = env.store.get("resourceclaims", "default/c1")
    assert c.allocation.node_name == "n1" and len(c.allocation.devices["dev"]) == 1
    assert "p" in c.reserved_for
    return claims(env)


def sc_pod_without_claim_unaffected(env):
    cluster(env)
    env.serial()
    env.store.create("pods", env.m.MakePod("plain").req({"cpu": "1"}).obj())
    env.drive()
    assert node_of(env, "plain") != ""
    return claims(env)


def sc_missing_claim_gates_pod_until_created(env):
    k = cluster(env)
    env.serial()
    env.store.create("pods", env.m.MakePod("p").req({"cpu": "1"}).claim("late").obj())
    env.drive()
    assert node_of(env, "p") == ""
    gated = sorted((qp.pod.metadata.name, tuple(qp.unschedulable_plugins))
                   for qp in env.sched.queue._unschedulable.values())
    assert gated == [("p", ("DynamicResources",))]
    env.store.create("resourceclaims", k.claim("late"))
    retry(env)
    assert node_of(env, "p") == "n1"
    return gated, claims(env)


def sc_device_exhaustion_blocks_second_pod(env):
    k = cluster(env, devices_per_node=1)
    env.store.create("resourceclaims", k.claim("c1"))
    env.store.create("resourceclaims", k.claim("c2"))
    env.serial()
    env.store.create("pods", env.m.MakePod("p1").req({"cpu": "1"}).claim("c1").obj())
    env.store.create("pods", env.m.MakePod("p2").req({"cpu": "1"}).claim("c2").obj())
    env.drive()
    assert sorted([node_of(env, "p1"), node_of(env, "p2")]) == ["", "n1"]
    return claims(env)


def sc_deallocate_frees_devices_for_next_pod(env):
    k = cluster(env, devices_per_node=1)
    env.store.create("resourceclaims", k.claim("c1"))
    env.store.create("resourceclaims", k.claim("c2"))
    env.serial()
    env.store.create("pods", env.m.MakePod("p1").req({"cpu": "1"}).claim("c1").obj())
    env.drive()
    assert node_of(env, "p1") == "n1"
    env.store.create("pods", env.m.MakePod("p2").req({"cpu": "1"}).claim("c2").obj())
    env.drive()
    assert node_of(env, "p2") == ""
    # p1 finishes; its claim is deallocated (the kubelet/controller side)
    plugin = next(p for fw in env.sched.profiles.values() for p in fw.plugins
                  if isinstance(p, k.plugin_cls))
    env.store.delete("pods", "default/p1")
    plugin.deallocate("default/c1")
    plugin.deallocate("default/no-such-claim")  # a missing claim is ignored
    retry(env)
    assert node_of(env, "p2") == "n1"
    assert env.store.get("resourceclaims", "default/c2").allocation is not None
    return claims(env)


def sc_multi_count_and_selector_requests(env):
    k = Dra(env.port)
    for i in range(2):
        env.store.create("nodes", env.m.MakeNode(f"n{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "20"}).obj())
    env.store.create("deviceclasses", k.dclass())
    # n0: two small devices; n1: two big devices
    env.store.create("resourceslices", k.slice("n0", ["small-0", "small-1"], driver="d",
                                               pool="p", mem=8, name="s0"))
    env.store.create("resourceslices", k.slice("n1", ["big-0", "big-1"], driver="d",
                                               pool="p", mem=32, name="s1"))
    env.store.create("resourceclaims", k.claim("big2", count=2, selectors=[
        k.d.DeviceAttributeRequirement(key="memGiB", op=">=", value=16)]))
    env.serial()
    env.store.create("pods", env.m.MakePod("p").req({"cpu": "1"}).claim("big2").obj())
    env.drive()
    assert node_of(env, "p") == "n1"
    got = env.store.get("resourceclaims", "default/big2")
    assert sorted(got.allocation.devices["dev"]) == ["big-0", "big-1"]
    return claims(env)


def sc_batch_scheduler_routes_claims_to_per_pod_cycle(env):
    k = cluster(env)
    env.store.create("resourceclaims", k.claim("c1"))
    env.batch("auto")
    env.store.create("pods", env.m.MakePod("claimer").req({"cpu": "1"}).claim("c1").obj())
    for i in range(5):
        env.store.create("pods", env.m.MakePod(f"plain-{i}").req({"cpu": "1"}).obj())
    env.drive()
    assert node_of(env, "claimer") == "n1"
    assert all(node_of(env, f"plain-{i}") for i in range(5))
    return claims(env)


def sc_template_claim_waits_for_claim_status(env):
    """A pod whose claim comes from a template waits (PreEnqueue) until its
    status.resourceClaimStatuses names the generated claim; that status
    write requeues it like a spec change (queue.update), and it binds."""
    k = cluster(env)
    env.store.create("resourceclaims", k.claim("p-gpu-abc"))
    env.serial()
    pod = env.m.MakePod("p").req({"cpu": "1"}).obj()
    pod.spec.resource_claim_templates = [("gpu", "gpu-template")]
    env.store.create("pods", pod)
    env.drive()
    assert node_of(env, "p") == ""
    gated = end_state(env)["queue"]

    def stamp(status):
        status.resource_claim_statuses = {"gpu": "p-gpu-abc"}

    env.store.update_pod_status("default", "p", stamp)
    env.sched.pump_events()
    moved = end_state(env)["queue"]
    env.clock.step(61)
    env.sched.queue.flush_backoff_completed()
    env.drive()
    assert node_of(env, "p") == "n1"
    assert env.store.get("resourceclaims", "default/p-gpu-abc").reserved_for == ["p"]
    return gated, moved, claims(env)


SCENARIOS = [sc_claiming_pod_lands_only_on_device_node, sc_template_claim_waits_for_claim_status, sc_pod_without_claim_unaffected,
             sc_missing_claim_gates_pod_until_created, sc_device_exhaustion_blocks_second_pod,
             sc_deallocate_frees_devices_for_next_pod, sc_multi_count_and_selector_requests,
             sc_batch_scheduler_routes_claims_to_per_pod_cycle]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_dra_scenario_matches_jax(scenario):
    want_env, got_env = Env(False), Env(True)
    want_x, got_x = scenario(want_env), scenario(got_env)
    assert got_x == want_x
    want, got = end_state(want_env), end_state(got_env)
    for key in want:
        assert got[key] == want[key], key


def test_gate_off_means_no_plugin():
    """The gate decides whether default_plugins holds DynamicResources, at
    index 8, in both packages."""
    for port, gates in ((False, jgates), (True, tgates)):
        pl = tpl if port else jpl
        gates.set("DynamicResourceAllocation", False)
        assert "DynamicResources" not in {p.name for p in pl.default_plugins()}
        gates.set("DynamicResourceAllocation", True)
        names = [p.name for p in pl.default_plugins()]
        assert names[8] == "DynamicResources"
    assert [p.name for p in tpl.default_plugins()] == [p.name for p in jpl.default_plugins()]


def test_plugin_points_and_hints_match_jax():
    """PreEnqueue, PreFilter (pinning by an allocated claim), Filter,
    Reserve and Unreserve on one plugin instance, and the claim hint, in
    both packages."""
    out = []
    for port in (False, True):
        env = Env(port)
        k = cluster(env, devices_per_node=2)
        env.store.create("resourceclaims", k.claim("c1"))
        pinned = k.claim("c2")
        pinned.allocation = k.d.AllocationResult(node_name="n1", devices={"dev": ["dev-1"]})
        env.store.create("resourceclaims", pinned)
        env.serial()
        plugin = k.plugin_cls(env.store)
        fw_mod = __import__(("kubernetes_tpu_torch" if port else "kubernetes_tpu")
                            + ".scheduler.framework", fromlist=["x"])
        snap = env.sched.cache.update_snapshot()
        rows = []
        for claim_names in (["c1"], ["c2"], ["c1", "c2"], ["nope"], []):
            b = env.m.MakePod("p")
            for cn in claim_names:
                b = b.claim(cn)
            pod = b.obj()
            state = fw_mod.CycleState()
            res, st = plugin.pre_filter(state, pod, snap)
            row = [(st.code.name, st.reasons), None if res is None else sorted(res.node_names),
                   plugin.pre_enqueue(pod).code.name]
            if st.is_success():
                row.append([plugin.filter(state, pod, ni).reasons
                            for ni in snap.node_info_list])
                row.append(plugin.reserve(state, pod, "n1").code.name)
                row.append(sorted(plugin._in_use_devices()))
                plugin.unreserve(state, pod, "n1")
                row.append(sorted(plugin._in_use_devices()))
            rows.append(row)
        hints = {(e.resource, e.action): e.hint for e in plugin.events_to_register()}
        pod = env.m.MakePod("p").claim("c1").obj()
        other = k.claim("other")
        mine = k.claim("c1")
        mine.allocation = k.d.AllocationResult(node_name="n1", devices={"dev": ["dev-0"]})
        other_alloc = k.claim("other")
        other_alloc.allocation = mine.allocation
        hint_rows = [(key, None if h is None else [h(pod, c) for c in (mine, other, other_alloc)])
                     for key, h in sorted(hints.items())]
        out.append((rows, hint_rows))
    assert out[0] == out[1]


def test_dra_types_round_trip_match_jax():
    """from_dict(to_dict(x)) and the wire shapes, in both packages."""
    out = []
    for port in (False, True):
        k = Dra(port)
        c = k.claim("c", count=2, selectors=[
            k.d.DeviceAttributeRequirement(key="memGiB", op="<=", value=32)])
        c.allocation = k.d.AllocationResult(node_name="n1", devices={"dev": ["a", "b"]})
        c.reserved_for = ["p"]
        objs = [c, k.slice("n1", ["a", "b"]), k.dclass()]
        row = [repr(o.to_dict()) for o in objs]
        row += [repr(type(o).from_dict(o.to_dict()).to_dict()) for o in objs]
        reqs = [k.d.DeviceAttributeRequirement(key="x", op=op, value=v)
                for op, v in (("==", 1), ("!=", 1), ("in", [1, 2]), ("exists", None),
                              (">=", 2), ("<=", 2), (">=", "bad"), ("??", 1))]
        row.append([r.matches(a) for r in reqs for a in ({"x": 1}, {"x": 3}, {})])
        out.append(row)
    assert out[0] == out[1]

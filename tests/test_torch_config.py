"""The port's scheduler configuration (scheduler/config.py
KubeSchedulerConfiguration.from_dict / validate, build_framework,
build_profiles, Scheduler.from_config) and feature gates
(utils/featuregate.py) against the JAX package's, tolerance 0.

The cases of tests/test_config_extender.py's TestComponentConfig,
TestFromConfig and TestFeatureGates run in both packages: defaults, every
validation error, per-point disables and weights, "*", profile routing, and
from_config's backoff and percentage. Extenders, not ported yet, raise
naming their ROADMAP item (queue 1 item 6).
"""

import pytest
from test_torch_serial import Env, assert_same

from kubernetes_tpu.scheduler import config as jcfg
from kubernetes_tpu.scheduler.serial import Scheduler as JScheduler
from kubernetes_tpu.utils import featuregate as jfg
from kubernetes_tpu_torch.scheduler import config as tcfg
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler as TBatch
from kubernetes_tpu_torch.scheduler.serial import Scheduler as TScheduler
from kubernetes_tpu_torch.store import APIStore as TStore
from kubernetes_tpu_torch.utils import featuregate as tfg

INVALID = [
    ({"parallelism": 0}, "parallelism"),
    ({"percentageOfNodesToScore": 150}, "percentageOfNodesToScore"),
    ({"podInitialBackoffSeconds": 0}, "podInitialBackoffSeconds"),
    ({"podInitialBackoffSeconds": 20}, "podMaxBackoffSeconds"),
    ({"profiles": [{"schedulerName": "a"}, {"schedulerName": "a"}]}, "duplicate"),
    ({"profiles": [{"schedulerName": "a",
                    "plugins": {"score": {"enabled": [{"name": "NoSuch"}]}}}]}, "unknown plugin"),
    ({"profiles": [{"schedulerName": "a", "plugins": {
        "score": {"enabled": [{"name": "ImageLocality", "weight": -1}]}}}]}, "negative weight"),
    ({"profiles": [{"schedulerName": ""}]}, "schedulerName is required"),
]


def message(mod, d):
    try:
        mod.KubeSchedulerConfiguration.from_dict(d).validate()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("patch,msg", INVALID, ids=[m for _, m in INVALID])
def test_validation_errors_match_jax(patch, msg):
    want = message(jcfg, patch)
    got = message(tcfg, patch)
    assert got == want and msg in got


def test_defaults_match_jax():
    j = jcfg.KubeSchedulerConfiguration.from_dict({})
    t = tcfg.KubeSchedulerConfiguration.from_dict({})
    for f in ("parallelism", "percentage_of_nodes_to_score", "pod_initial_backoff_seconds",
              "pod_max_backoff_seconds"):
        assert getattr(t, f) == getattr(j, f)
    assert [p.scheduler_name for p in t.profiles] == ["default-scheduler"]
    t.validate()


PROFILE_CASES = [
    {"profiles": [{"schedulerName": "custom", "plugins": {
        "score": {"disabled": [{"name": "ImageLocality"}],
                  "enabled": [{"name": "TaintToleration", "weight": 7}]},
        "filter": {"disabled": [{"name": "NodePorts"}]}}}]},
    {"profiles": [{"schedulerName": "scores-off", "plugins": {"score": {"disabled": [{"name": "*"}]}}}]},
    {"percentageOfNodesToScore": 30, "profiles": [
        {"schedulerName": "default-scheduler", "percentageOfNodesToScore": 70},
        {"schedulerName": "quiet", "plugins": {"postFilter": {"disabled": [{"name": "*"}]},
                                               "preScore": {"disabled": [{"name": "*"}]}}}]},
    {"profiles": [{"schedulerName": "re", "plugins": {
        "filter": {"disabled": [{"name": "*"}], "enabled": [{"name": "NodeResourcesFit"}]}}}]},
    # a volume plugin disabled: nothing to disable in the port, same result
    {"profiles": [{"schedulerName": "v", "plugins": {
        "filter": {"disabled": [{"name": "VolumeBinding"}]}}}]},
]

POINTS = ("pre_enqueue_plugins", "pre_filter_plugins", "filter_plugins", "post_filter_plugins",
          "pre_score_plugins", "score_plugins", "reserve_plugins", "permit_plugins",
          "pre_bind_plugins", "bind_plugins", "post_bind_plugins")


def profile_view(profiles):
    return {name: ({pt: [p.name for p in getattr(fw, pt)] for pt in POINTS},
                   {k: v for k, v in fw.weights.items()}, fw.percentage_of_nodes_to_score,
                   fw.profile_name, fw.queue_sort_plugin.name)
            for name, fw in profiles.items()}


@pytest.mark.parametrize("case", range(len(PROFILE_CASES)))
def test_build_profiles_matches_jax(case):
    d = PROFILE_CASES[case]
    jprof, jext = jcfg.build_profiles(jcfg.KubeSchedulerConfiguration.from_dict(d))
    tprof, text = tcfg.build_profiles(tcfg.KubeSchedulerConfiguration.from_dict(d))
    assert profile_view(tprof) == profile_view(jprof)
    assert text == jext == []


@pytest.mark.parametrize("extenders", [[{"urlPrefix": "http://127.0.0.1:1", "weight": 1}],
                                       [{"weight": 1}]], ids=["valid", "no-url"])
def test_extenders_raise_with_their_item(extenders):
    """Any extender, valid or not, raises naming its ROADMAP item; the
    JAX package parses it."""
    jcfg.KubeSchedulerConfiguration.from_dict({"extenders": extenders})
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tcfg.KubeSchedulerConfiguration.from_dict({"extenders": extenders})
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        TScheduler.from_config(TStore(), {"extenders": extenders})
    # an empty list is no extender
    tcfg.build_profiles(tcfg.KubeSchedulerConfiguration.from_dict({"extenders": []}))


def test_unported_parts_raise_with_their_item():
    """Only extenders are left to port: a profile that enables any plugin of
    the JAX registry, the volume plugins included, validates and builds the
    same framework in both packages, and the registries are equal."""
    volume = ("VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone")
    for name in volume:
        d = {"profiles": [{"schedulerName": "v", "plugins": {
            "filter": {"disabled": [{"name": "*"}], "enabled": [{"name": name}]}}}]}
        cfgs = [mod.KubeSchedulerConfiguration.from_dict(d) for mod in (jcfg, tcfg)]
        for cfg in cfgs:
            cfg.validate()
        jprof, _ = jcfg.build_profiles(cfgs[0])
        tprof, _ = tcfg.build_profiles(cfgs[1])
        assert profile_view(tprof) == profile_view(jprof)
        assert [p.name for p in tprof["v"].filter_plugins] == [name]
    assert list(tcfg.plugin_registry()) == list(jcfg.plugin_registry())
    # one VolumeLister shared by the volume plugins of every profile
    from kubernetes_tpu_torch.scheduler.plugins import VolumeLister

    vl = VolumeLister()
    prof, _ = tcfg.build_profiles(tcfg.KubeSchedulerConfiguration.from_dict(
        {"profiles": [{"schedulerName": "a"}, {"schedulerName": "b"}]}), vl)
    assert {id(p.lister) for fw in prof.values() for p in fw.plugins
            if hasattr(p, "lister")} == {id(vl)}
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        tcfg.KubeSchedulerConfiguration.from_dict({"extenders": [{"weight": 1}]})


def sc_from_config(env):
    env.store.create("nodes", env.m.MakeNode("n1").capacity(
        {"cpu": "4", "memory": "8Gi", "pods": "10"}).obj())
    env.store.create("nodes", env.m.MakeNode("n2").capacity(
        {"cpu": "8", "memory": "8Gi", "pods": "10"}).obj())
    cfg = {"podInitialBackoffSeconds": 2, "podMaxBackoffSeconds": 20,
           "percentageOfNodesToScore": 0,
           "profiles": [{"schedulerName": "default-scheduler"},
                        {"schedulerName": "quiet",
                         "plugins": {"score": {"disabled": [{"name": "*"}]}}}]}
    cls = TScheduler if env.port else JScheduler
    env.sched = cls.from_config(env.store, cfg, clock=env.clock)
    env.sched.sync()
    pods = [env.m.MakePod(f"p{i}").req({"cpu": "1"}).obj() for i in range(4)]
    pods[1].spec.scheduler_name = "quiet"
    pods[2].spec.scheduler_name = "not-ours"
    env.create(pods)
    env.drive()
    q = env.sched.queue
    return q._initial_backoff, q._max_backoff, env.sched.percentage


def test_from_config_matches_jax():
    got, _ = assert_same(sc_from_config)
    assert got["placement"]["p2"] == ""


def test_batch_scheduler_from_config():
    store = TStore()
    sched = TBatch.from_config(store, {"podInitialBackoffSeconds": 3, "podMaxBackoffSeconds": 9,
                                       "profiles": [{"schedulerName": "default-scheduler"}]},
                               device="cpu", solver="auto")
    assert (sched.queue._initial_backoff, sched.queue._max_backoff) == (3, 9)
    assert sched.solver == "auto" and sched.preemption is not None
    assert "default-scheduler" in sched.profiles
    assert sched.percentage == 0  # from the configuration, through **kw


# PROFILE_CASES whose profiles change what the batch solvers encode: the
# Score set or weights (0, 1), PreScore (2), the Filter set (0, 3)
ENCODED_CHANGES = {0: True, 1: True, 2: True, 3: True, 4: False}


@pytest.mark.parametrize("case", range(len(PROFILE_CASES)))
def test_batch_scheduler_refuses_profiles_the_solvers_do_not_encode(case):
    """The serial scheduler honours every profile; the batch scheduler
    raises, naming the per-pod route's ROADMAP item, for a profile that
    changes the plugins, arguments or weights its solvers encode."""
    d = PROFILE_CASES[case]
    TScheduler.from_config(TStore(), d)
    if ENCODED_CHANGES[case]:
        with pytest.raises(NotImplementedError, match="deliberate differences"):
            TBatch.from_config(TStore(), d, device="cpu", solver="auto")
    else:
        TBatch.from_config(TStore(), d, device="cpu", solver="auto")


def test_batch_scheduler_refuses_changed_plugin_arguments_and_weights():
    from kubernetes_tpu_torch.scheduler.plugins import (
        InterPodAffinity,
        NodeResourcesFit,
        default_plugins,
    )
    from kubernetes_tpu_torch.scheduler.runtime import Framework

    def swapped(cls, **args):
        return [cls(**args) if isinstance(p, cls) else p for p in default_plugins()]

    bad = [Framework(default_plugins(), weights={"ImageLocality": 5}),
           Framework(swapped(NodeResourcesFit, strategy="MostAllocated")),
           Framework(default_plugins(), disabled_points={("NodePorts", "filter")})]
    for fw in bad:
        with pytest.raises(NotImplementedError, match="deliberate differences"):
            TBatch(TStore(), fw, device="cpu")
    # hardPodAffinityWeight is read from the profile, not assumed
    sched = TBatch(TStore(), Framework(swapped(InterPodAffinity, hard_pod_affinity_weight=5)),
                   device="cpu")
    assert sched._hard_pod_affinity_weight() == 5


def test_feature_gates_match_jax():
    """The port registers exactly the gates it reads, with the JAX
    package's defaults and stages; set/enabled behave the same."""
    assert set(tfg.DEFAULT_FEATURE_GATES) == {"SchedulerQueueingHints",
                                              "SchedulerAsyncPreemption",
                                              "DynamicResourceAllocation"}
    for name, spec in tfg.DEFAULT_FEATURE_GATES.items():
        want = jfg.DEFAULT_FEATURE_GATES[name]
        assert (spec.default, spec.stage) == (want.default, want.stage)
    for name in tfg.DEFAULT_FEATURE_GATES:
        seen = []
        for mod in (jfg, tfg):
            gates = mod.default_feature_gates()
            before = gates.enabled(name)
            gates.set(name, not before)
            seen.append((before, gates.enabled(name)))
        assert seen[0] == seen[1]
    for mod in (jfg, tfg):
        gates = mod.default_feature_gates()
        with pytest.raises(KeyError):
            gates.enabled("NoSuch")
        with pytest.raises(KeyError):
            gates.set("NoSuch", True)
    # a gate the JAX package has and the port does not read is not settable
    with pytest.raises(KeyError):
        tfg.feature_gates.set("VolumeCapacityPriority", True)


def test_async_preemption_gate_sets_the_plugin_default():
    from kubernetes_tpu_torch.scheduler.plugins.default_preemption import DefaultPreemption

    tfg.feature_gates.set("SchedulerAsyncPreemption", False)
    try:
        assert DefaultPreemption().async_preparation is False
    finally:
        tfg.feature_gates.set("SchedulerAsyncPreemption", True)
    assert DefaultPreemption().async_preparation is True
    assert Env(True).serial().framework.post_filter_plugins[0].async_preparation is True

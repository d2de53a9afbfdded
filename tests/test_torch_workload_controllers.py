"""The port's Job, indexed Job, CronJob, StatefulSet and DaemonSet
controllers and its cron parser against the JAX package's.

Each scenario follows a case of tests/test_workload_controllers.py and runs
on both packages through the same call sequence on a FakeClock (pod phase
writes stand in for the node agent). The outcomes are compared exactly as in
tests/test_torch_controllers.py: the normalized store dump, the store's event
sequence with its resource versions, the {pod: node} map, the reconcile
counts and what each step observed.
"""

import contextlib
import random
import uuid
from datetime import datetime, timezone

import numpy as np
import pytest

import kubernetes_tpu.utils.cron as jcron
import kubernetes_tpu_torch.utils.cron as tcron
from test_torch_controllers import run_both


def set_phase(store, key, phase):
    def mutate(p):
        p.status.phase = phase
        return p

    store.guaranteed_update("pods", key, mutate)


def _names(store, live_only=False):
    pods, _ = store.list("pods")
    return sorted(p.metadata.name for p in pods if not (live_only and p.is_terminal()))


def _live(store):
    return sorted((p for p in store.list("pods")[0] if not p.is_terminal()),
                  key=lambda p: p.metadata.name)


def _run_pending(store):
    """Mark every created, non-terminal pod Running (the reference tests'
    hand step)."""
    changed = False
    for p in store.list("pods")[0]:
        if p.status.phase != "Running" and not p.is_terminal():
            set_phase(store, p.key, "Running")
            changed = True
    return changed


def _image(value):
    def mutate(obj):
        obj.spec.template.spec.containers[0].image = value
        return obj
    return mutate


# -- the cron parser -----------------------------------------------------------------

CRON_CASES = [("*/15 * * * *", ""), ("@hourly", ""), ("30 6 * * *", ""),
              ("0 0 * * 7", ""), ("5/15 * * * *", ""), ("0 9 * * 1-5", "Europe/Berlin"),
              ("30 6 * * *", "America/New_York"), ("* * * * *", "America/New_York"),
              ("30 2 * * *", "America/New_York"), ("0 */6 1,15 * *", "Asia/Kolkata")]


@pytest.mark.parametrize("expr,tz", CRON_CASES)
def test_cron_schedule_matches_jax(expr, tz):
    """Seeded start times, including both 2026 New York transitions: the
    same fields, the same next fire times and the same windows."""
    rng = np.random.default_rng(len(expr) * 31 + len(tz))
    dst = [datetime(2026, 11, 1, 5, 30, tzinfo=timezone.utc).timestamp(),
           datetime(2026, 3, 8, 6, 0, tzinfo=timezone.utc).timestamp()]
    starts = dst + [float(x) for x in rng.integers(0, 2_000_000_000, 6)]
    j, t = jcron.CronSchedule(expr, tz=tz), tcron.CronSchedule(expr, tz=tz)
    assert (t.minutes, t.hours) == (j.minutes, j.hours)
    for ts in starts:
        jn, tn = [], []
        a = b = ts
        for _ in range(40):
            a, b = j.next_after(a), t.next_after(b)
            jn.append(a)
            tn.append(b)
        assert tn == jn and all(x < y for x, y in zip([ts] + tn, tn))
        assert t.times_between(ts, ts + 7200) == j.times_between(ts, ts + 7200)


@pytest.mark.parametrize("expr,tz", [("* * * *", ""), ("61 * * * *", ""), ("*/0 * * * *", ""),
                                     ("* * * * 8", ""), ("* * * * *", "Mars/Olympus")])
def test_invalid_cron_raises_as_in_jax(expr, tz):
    for mod in (jcron, tcron):
        with pytest.raises(ValueError):
            mod.CronSchedule(expr, tz=tz)


# -- Job and indexed Job ------------------------------------------------------------------


def make_job(m, name="j", parallelism=2, completions=3, backoff_limit=2, **kw):
    job = m.wl.Job.from_dict({
        "metadata": {"name": name},
        "spec": {"parallelism": parallelism, "completions": completions,
                 "backoffLimit": backoff_limit,
                 "template": {"metadata": {"labels": {"app": name}},
                              "spec": {"containers": [{"name": "c", "image": "worker"}]}},
                 **kw}})
    job.metadata.uid = m.types.new_uid()
    return job


JOB_CASES = {
    "parallelism": dict(parallelism=2, completions=3),
    "completion": dict(parallelism=2, completions=2),
    "nil_completions": dict(parallelism=3, completions=None),
    "nil_completions_lowered": dict(parallelism=5, completions=None),
    "backoff_limit": dict(parallelism=1, completions=1, backoff_limit=1),
    "parallelism_zero": dict(parallelism=0, completions=1),
    "scale_down": dict(parallelism=3, completions=5),
    "cascade": dict(),
    "indexed_identity": dict(parallelism=3, completions=3, completionMode="Indexed"),
    "indexed_failed_retried": dict(parallelism=2, completions=2, backoffLimit=3,
                                   completionMode="Indexed"),
    "indexed_window": dict(parallelism=2, completions=5, completionMode="Indexed"),
    "indexed_no_completions": dict(completionMode="Indexed"),
}


@contextlib.contextmanager
def seeded_uuid4(seed=0):
    """Job pods take a random name suffix (uuid4, as in both packages): draw
    it from one seeded sequence per run so the two runs name alike."""
    rng, orig = random.Random(seed), uuid.uuid4
    uuid.uuid4 = lambda: uuid.UUID(int=rng.getrandbits(128), version=4)
    try:
        yield
    finally:
        uuid.uuid4 = orig


def sc_job(m, case):
    with seeded_uuid4():
        return _sc_job(m, case)


def _sc_job(m, case):
    store = m.Store()
    clock = m.Clock(1000.0)
    kw = dict(JOB_CASES[case])
    job = make_job(m, **kw)
    if case == "indexed_no_completions":
        job.spec.completions = None
    store.create("jobs", job)
    ctl = m.ctl.JobController(store, clock=clock)
    ctl.sync_all()
    ctl.process()
    seen = [_names(store)]
    live = _live(store)
    index = m.ctl.job.pod_completion_index
    if case in ("completion", "indexed_identity"):
        for p in live:
            set_phase(store, p.key, "Succeeded")
        ctl.reconcile_once()
        ctl.reconcile_once()
    elif case == "nil_completions":
        set_phase(store, live[0].key, "Succeeded")
        ctl.reconcile_once()
        for p in live[1:]:
            set_phase(store, p.key, "Succeeded")
        ctl.reconcile_once()
    elif case in ("nil_completions_lowered", "scale_down"):
        if case == "nil_completions_lowered":
            set_phase(store, live[0].key, "Succeeded")
        store.guaranteed_update("jobs", "default/j",
                                lambda j: (setattr(j.spec, "parallelism", 1), j)[1])
        ctl.reconcile_once()
    elif case == "backoff_limit":
        set_phase(store, live[0].key, "Failed")
        ctl.reconcile_once()
        set_phase(store, _live(store)[0].key, "Failed")
        ctl.reconcile_once()
    elif case == "cascade":
        store.delete("jobs", "default/j")
        ctl.reconcile_once()
    elif case == "indexed_failed_retried":
        victim = next(p for p in live if index(p) == 1)
        set_phase(store, victim.key, "Failed")
        ctl.reconcile_once()
        ctl.reconcile_once()
        retried = next(p for p in _live(store) if index(p) == 1)
        set_phase(store, retried.key, "Succeeded")
        ctl.reconcile_once()
    elif case == "indexed_window":
        for p in live:
            set_phase(store, p.key, "Succeeded")
        ctl.reconcile_once()
        ctl.reconcile_once()
    seen.append(_names(store, live_only=True))
    try:
        j = store.get("jobs", "default/j")
        status = (j.status.active, j.status.succeeded, j.status.failed,
                  j.status.completed_indexes, j.is_finished(),
                  sorted(c.get("reason", c["type"]) for c in j.status.conditions))
    except m.NotFound:
        status = None
    indexes = sorted(index(p) for p in _live(store))
    policies = sorted({p.spec.restart_policy for p in store.list("pods")[0]})
    return store, [ctl], {"seen": seen, "status": status, "indexes": indexes,
                          "policies": policies}


@pytest.mark.parametrize("case", sorted(JOB_CASES))
def test_job_matches_jax(case):
    out = run_both(sc_job, case)["extra"]
    finished = {"completion", "nil_completions", "backoff_limit", "indexed_identity",
                "indexed_no_completions"}
    if out["status"] is not None:
        assert out["status"][4] == (case in finished)
    want_live = {"parallelism": 2, "parallelism_zero": 0, "scale_down": 1,
                 "nil_completions_lowered": 1, "cascade": 0, "indexed_window": 2}
    if case in want_live:
        assert len(out["seen"][-1]) == want_live[case]
    if case == "indexed_window":
        assert out["indexes"] == [2, 3]
    if out["policies"]:
        assert out["policies"] == ["Never"]


# -- CronJob --------------------------------------------------------------------------


CRONJOB_CASES = {
    "on_schedule": ("*/10 * * * *", {}, 1000.0),
    "forbid": ("*/10 * * * *", {"concurrencyPolicy": "Forbid"}, 1000.0),
    "replace": ("*/10 * * * *", {"concurrencyPolicy": "Replace"}, 1000.0),
    "suspend": ("*/10 * * * *", {"suspend": True}, 1000.0),
    "history": ("*/10 * * * *", {"successfulJobsHistoryLimit": 1}, 1000.0),
    "time_zone": ("0 9 * * *", {"timeZone": "Europe/Berlin"},
                  datetime(2026, 3, 28, 0, 0, tzinfo=timezone.utc).timestamp()),
    "dst_fall_back": ("30 1 * * *", {"timeZone": "America/New_York"},
                      datetime(2026, 10, 31, 12, 0, tzinfo=timezone.utc).timestamp()),
    "bad_zone": ("0 9 * * *", {"timeZone": "Amerca/Typo"}, 1000.0),
}


def sc_cronjob(m, case):
    schedule, kw, start = CRONJOB_CASES[case]
    store = m.Store()
    clock = m.Clock(start)
    cj = m.wl.CronJob.from_dict({
        "metadata": {"name": "tick", "creationTimestamp": start},
        "spec": {"schedule": schedule,
                 "jobTemplate": {"spec": {"template": {"spec": {"containers": [{"name": "c"}]}}}},
                 **kw}})
    cj.metadata.uid = m.types.new_uid()
    store.create("cronjobs", cj)
    ctl = m.ctl.CronJobController(store, clock=clock)
    ctl.sync_all()
    ctl.process()
    seen = []
    steps = {"time_zone": [86400.0] * 4, "dst_fall_back": [43200.0] * 6}.get(case, [201, 600,
                                                                                  600, 600])
    for dt in steps:
        clock.step(dt)
        ctl.resync_due()
        ctl.process()
        if case == "history":
            for j in store.list("jobs", lambda j: not j.is_finished())[0]:
                store.guaranteed_update("jobs", j.key, lambda o: (
                    setattr(o.status, "conditions", [{"type": "Complete", "status": "True"}]),
                    o)[1])
        seen.append(sorted(j.metadata.name for j in store.list("jobs")[0]))
    last = store.get("cronjobs", "default/tick").status.last_schedule_time
    return store, [ctl], {"seen": seen, "last": last, "errors": ctl.sync_errors}


@pytest.mark.parametrize("case", sorted(CRONJOB_CASES))
def test_cronjob_matches_jax(case):
    out = run_both(sc_cronjob, case)["extra"]
    assert out["errors"] == 0
    if case == "on_schedule":
        assert out["seen"][0] == ["tick-20"] and out["last"] is not None
    if case in ("suspend", "bad_zone"):
        assert out["seen"][-1] == []
    if case == "forbid":
        assert len(out["seen"][-1]) == 1
    if case in ("time_zone", "dst_fall_back"):
        assert len(out["seen"][-1]) >= 2


# -- StatefulSet ----------------------------------------------------------------------


def make_sts(m, replicas=3, policy="OrderedReady", claims=(), **spec_kw):
    sts = m.wl.StatefulSet.from_dict({
        "metadata": {"name": "db"},
        "spec": {"replicas": replicas, "podManagementPolicy": policy, "serviceName": "db",
                 "template": {"metadata": {"labels": {"app": "db"}},
                              "spec": {"containers": [{"name": "c", "image": "v1"}]}},
                 "volumeClaimTemplates": [
                     {"metadata": {"name": c},
                      "spec": {"accessModes": ["ReadWriteOnce"],
                               "resources": {"requests": {"storage": "1Gi"}}}}
                     for c in claims],
                 **spec_kw}})
    sts.metadata.uid = m.types.new_uid()
    return sts


def _settle_sts(store, ctl):
    for _ in range(30):
        ctl.reconcile_once()
        if not _run_pending(store) and ctl.reconcile_once() == 0:
            break
    return _names(store, live_only=True)


STS_CASES = ["ordered", "parallel", "scale_down", "pvcs", "roll_highest_first",
             "partition", "on_delete", "scaledown_and_update"]


def sc_statefulset(m, case):
    store = m.Store()
    kw = {"parallel": dict(policy="Parallel"), "scale_down": dict(policy="Parallel"),
          "pvcs": dict(replicas=1, claims=("data",)),
          "partition": dict(updateStrategy={"type": "RollingUpdate",
                                            "rollingUpdate": {"partition": 2}}),
          "on_delete": dict(updateStrategy={"type": "OnDelete"})}.get(case, {})
    store.create("statefulsets", make_sts(m, **kw))
    ctl = m.ctl.StatefulSetController(store, clock=m.Clock(0.0))
    ctl.sync_all()
    rev = m.ctl.statefulset.REVISION_LABEL
    seen = []
    if case == "ordered":
        ctl.process()
        for i in range(2):
            seen.append(_names(store))
            set_phase(store, f"default/db-{i}", "Running")
            ctl.reconcile_once()
        seen.append(_names(store))
    elif case in ("parallel", "scale_down"):
        ctl.process()
        seen.append(_names(store))
        if case == "scale_down":
            _run_pending(store)
            store.guaranteed_update("statefulsets", "default/db",
                                    lambda o: (setattr(o.spec, "replicas", 1), o)[1])
            ctl.reconcile_once()
            ctl.reconcile_once()
            seen.append(_names(store))
    elif case == "pvcs":
        ctl.process()
        set_phase(store, "default/db-0", "Failed")
        ctl.reconcile_once()
        ctl.reconcile_once()
        pod = store.get("pods", "default/db-0")
        seen.append([pod.spec.volumes[0].pvc_claim_name, pod.status.phase,
                     store.get("persistentvolumeclaims", "default/data-db-0").spec.request])
    else:
        seen.append(_settle_sts(store, ctl))
        if case == "scaledown_and_update":
            store.guaranteed_update("statefulsets", "default/db", lambda o: (
                setattr(o.spec, "replicas", 2),
                setattr(o.spec.template.spec.containers[0], "image", "v2"), o)[2])
            ctl.reconcile_once()
            seen.append(_names(store))
        else:
            store.guaranteed_update("statefulsets", "default/db", _image("v2"))
            ctl.reconcile_once()
            seen.append(_names(store))
            seen.append(_settle_sts(store, ctl))
            if case == "on_delete":
                store.delete("pods", "default/db-1")
                seen.append(_settle_sts(store, ctl))
    revs = {p.metadata.name: p.metadata.labels.get(rev) for p in _live(store)}
    sts = store.get("statefulsets", "default/db").status
    return store, [ctl], {"seen": seen, "revs": revs,
                          "status": (sts.replicas, sts.ready_replicas, sts.current_replicas,
                                     sts.updated_replicas, sts.update_revision)}


@pytest.mark.parametrize("case", STS_CASES)
def test_statefulset_matches_jax(case):
    out = run_both(sc_statefulset, case)["extra"]
    if case == "ordered":
        assert out["seen"] == [["db-0"], ["db-0", "db-1"], ["db-0", "db-1", "db-2"]]
    if case == "roll_highest_first":
        assert out["seen"][1] == ["db-0", "db-1"] and out["status"][3] == 3
        assert len(set(out["revs"].values())) == 1
    if case == "partition":
        assert out["revs"]["db-0"] == out["revs"]["db-1"] != out["revs"]["db-2"]
    if case == "on_delete":
        assert out["revs"]["db-1"] != out["revs"]["db-0"]
    if case == "scaledown_and_update":
        assert len(out["seen"][-1]) == 2


# -- DaemonSet -------------------------------------------------------------------------


def make_ds(m, image="v1", **spec_kw):
    ds = m.wl.DaemonSet.from_dict({
        "metadata": {"name": "agent"},
        "spec": {"template": {"metadata": {"labels": {"app": "agent"}},
                              "spec": {"containers": [{"name": "c", "image": image}]}},
                 **spec_kw}})
    ds.metadata.uid = m.types.new_uid()
    return ds


DS_CASES = ["one_per_node", "new_node", "tainted", "node_selector", "node_deleted",
            "roll_one_at_a_time", "budget", "on_delete", "stuck_pod"]


def _by_node(store):
    return sorted((p.spec.node_name, p.metadata.name) for p in _live(store))


def _settle_ds(store, ctl):
    for _ in range(20):
        ctl.reconcile_once()
        _run_pending(store)
        if ctl.reconcile_once() == 0:
            break
    return _by_node(store)


def sc_daemonset(m, case):
    store = m.Store()
    n_nodes = {"new_node": 1, "tainted": 1, "node_selector": 1, "node_deleted": 2,
               "budget": 4, "stuck_pod": 2}.get(case, 3)
    for i in range(n_nodes):
        store.create("nodes", m.t.MakeNode(f"n{i}").capacity({"cpu": "8"}).obj())
    kw = {"budget": dict(updateStrategy={"type": "RollingUpdate",
                                         "rollingUpdate": {"maxUnavailable": 2}}),
          "on_delete": dict(updateStrategy={"type": "OnDelete"})}.get(case, {})
    store.create("daemonsets", make_ds(m, image="broken" if case == "stuck_pod" else "v1",
                                       **kw))
    ctl = m.ctl.DaemonSetController(store, clock=m.Clock(0.0))
    ctl.sync_all()
    seen = []
    if case in ("one_per_node", "new_node", "tainted", "node_selector", "node_deleted"):
        ctl.process()
        seen.append(_by_node(store))
        if case == "new_node":
            store.create("nodes", m.t.MakeNode("n9").capacity({"cpu": "4"}).obj())
            ctl.reconcile_once()
        elif case == "tainted":
            store.create("nodes", m.t.MakeNode("gpu").capacity({"cpu": "4"}).taints(
                [m.types.Taint(key="gpu", value="true", effect="NoSchedule")]).obj())
            ctl.reconcile_once()
        elif case == "node_selector":
            store.guaranteed_update("daemonsets", "default/agent", lambda o: (
                setattr(o.spec.template.spec, "node_selector", {"role": "special"}), o)[1])
            ctl.reconcile_once()
            ctl.reconcile_once()
        elif case == "node_deleted":
            store.delete("nodes", "n1")
            ctl.reconcile_once()
        seen.append(_by_node(store))
    elif case == "stuck_pod":
        ctl.reconcile_once()
        pods = {p.spec.node_name: p for p in store.list("pods")[0]}
        set_phase(store, pods["n0"].key, "Running")
        store.guaranteed_update("daemonsets", "default/agent", _image("fixed"))
        for _ in range(8):
            ctl.reconcile_once()
            _run_pending(store)
        seen.append(sorted((p.spec.node_name, p.spec.containers[0].image)
                           for p in _live(store)))
    else:
        seen.append(_settle_ds(store, ctl))
        store.guaranteed_update("daemonsets", "default/agent", _image("v2"))
        ctl.reconcile_once()
        seen.append(_names(store))
        seen.append(_settle_ds(store, ctl))
    ds = store.get("daemonsets", "default/agent").status
    rev = m.ctl.daemonset.REVISION_LABEL
    return store, [ctl], {
        "seen": seen, "revs": sorted({p.metadata.labels.get(rev) for p in _live(store)}),
        "status": (ds.desired_number_scheduled, ds.current_number_scheduled, ds.number_ready,
                   ds.number_misscheduled, ds.updated_number_scheduled)}


@pytest.mark.parametrize("case", DS_CASES)
def test_daemonset_matches_jax(case):
    out = run_both(sc_daemonset, case)
    extra = out["extra"]
    nodes = sorted(out["placements"].values())
    want = {"one_per_node": ["n0", "n1", "n2"], "new_node": ["n0", "n9"], "tainted": ["n0"],
            "node_selector": [], "node_deleted": ["n0"]}
    if case in want:
        assert nodes == want[case]
    if case == "roll_one_at_a_time":
        assert len(extra["seen"][1]) == 2 and extra["status"][4] == 3
    if case == "budget":
        assert len(extra["seen"][1]) == 2
    if case in ("roll_one_at_a_time", "budget", "stuck_pod"):
        assert len(extra["revs"]) == 1
    if case == "on_delete":
        assert extra["seen"][-1] == extra["seen"][0]
    if case == "stuck_pod":
        assert extra["seen"][0] == [["n0", "fixed"], ["n1", "fixed"]]

"""The port's authentication, authorization, audit, token requests, API
Priority and Fairness, server-side apply and aggregation layer against the
JAX package's.

The server-side cases of the JAX package's test_auth_patch.py (token authn,
RBAC, status subresources), test_audit_tokenrequest.py, test_flowcontrol.py,
test_ssa.py and test_aggregation.py, each run on both packages through
test_torch_server.py's `twin` and compared after its normalization. Cases
that drive `ktl` or `kadm` wait for ROADMAP.md queue 1 item 7g2.
"""

from __future__ import annotations

import copy
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List

import pytest
from test_torch_server import PODS, Run, open_stream, read_frames, twin, wait

CPOD = {"metadata": {"name": "p"}, "spec": {"containers": [{"name": "c", "image": "v1"}]}}


def _user(r: Run, name: str, *groups: str):
    return r.k("server.auth").UserInfo(name=name, groups=tuple(groups))


# -- authentication and authorization --------------------------------------------


def scn_token_authn_and_rbac(r: Run) -> None:
    auth = r.k("server.auth")
    authn = auth.TokenAuthenticator.from_csv_lines([
        "# comment", 'tok-sched,system:kube-scheduler,uid1,"system:kube-scheduler"',
        "tok-plain,alice,uid2"])
    u = authn.authenticate("Bearer tok-sched")
    r.note("csv", [u.name, sorted(u.groups), authn.authenticate("Bearer nope"),
                   authn.authenticate("")])
    a = auth.RBACAuthorizer().grant("bob", ["get", "list"], ["pods"])
    bob = auth.UserInfo("bob")
    r.note("rbac", [a.authorize(bob, "get", "pods"), a.authorize(bob, "delete", "pods"),
                    a.authorize(bob, "get", "nodes"),
                    a.authorize(auth.UserInfo("eve"), "get", "pods")])
    authn = auth.TokenAuthenticator()
    authn.add("good", "alice", ["system:masters"])
    authn.add("viewer-tok", "viewer", [])
    srv = r.server(authenticator=authn, authorizer=auth.default_component_authorizer())
    anon, ok = r.client(srv), r.client(srv, token="good")
    spoof, viewer = r.client(srv, user="system:admin"), r.client(srv, token="viewer-tok")
    r.call("anon", lambda: anon.list("pods"))
    r.call("ok", lambda: ok.list("pods"))
    r.call("spoof", lambda: spoof.list("pods"))
    r.call("viewer-read", lambda: viewer.list("pods"))
    r.call("viewer-write", lambda: viewer.create("pods", {
        "kind": "Pod", "metadata": {"name": "x", "namespace": "default"}}))
    for verb, res in (("create", "pods"), ("delete", "nodes"), ("list", "secrets")):
        r.http(srv, "POST", "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews",
               {"kind": "SelfSubjectAccessReview", "spec": {"resourceAttributes": {
                   "verb": verb, "resource": res, "namespace": "default"}}},
               headers={"Authorization": "Bearer viewer-tok"}, label=f"ssar-{verb}-{res}")
    r.http(srv, "POST", "/apis/authorization.k8s.io/v1/selfsubjectaccessreviews",
           {"spec": {}}, headers={"Authorization": "Bearer good"}, label="ssar-empty")
    r.http(srv, "GET", "/healthz", label="healthz-anon")
    r.http(srv, "GET", "/metrics", label="metrics-anon", record=False)


def scn_status_subresource_authz(r: Run) -> None:
    auth = r.k("server.auth")
    authn = auth.TokenAuthenticator()
    authn.add("t-status", "statuser")
    authn.add("t-admin", "admin", ["system:masters"])
    authn.add("t-patcher", "patcher")
    authz = (auth.RBACAuthorizer().grant("group:system:masters", ["*"], ["*"])
             .grant("statuser", ["update"], ["pods/status"])
             .grant("statuser", ["get", "list"], ["pods"])
             .grant("patcher", ["patch"], ["pods/status"])
             .grant("patcher", ["get"], ["pods"]))
    srv = r.server(authenticator=authn, authorizer=authz)
    admin = r.client(srv, token="t-admin")
    su, pt = r.client(srv, token="t-status"), r.client(srv, token="t-patcher")
    r.call("create", lambda: admin.create("pods", copy.deepcopy(CPOD)))
    r.call("status-put", lambda: su.update_status("pods", {
        "metadata": {"name": "p"}, "spec": {"containers": [{"name": "c", "image": "EVIL"}]},
        "status": {"phase": "Running"}}))
    cur = su.get("pods", "p")
    r.call("full-put", lambda: su.update("pods", cur))
    r.call("status-patch", lambda: pt.request(
        "PATCH", "/api/v1/namespaces/default/pods/p/status",
        {"spec": {"containers": [{"name": "c", "image": "EVIL"}]},
         "status": {"phase": "Succeeded"}}, content_type="application/merge-patch+json"))
    r.call("bare-patch", lambda: pt.patch("pods", "p", {"metadata": {"labels": {"a": "b"}}}))
    # optimistic concurrency on status writes: a stale body RV is a 409,
    # no RV is last-write-wins
    cur = admin.get("pods", "p")
    rv = cur["metadata"]["resourceVersion"]
    r.call("occ-1", lambda: admin.update_status("pods", {
        "metadata": {"name": "p", "resourceVersion": rv}, "status": {"phase": "Running"}}))
    r.call("occ-stale", lambda: admin.update_status("pods", {
        "metadata": {"name": "p", "resourceVersion": rv}, "status": {"phase": "Failed"}}))
    r.call("occ-none", lambda: admin.update_status("pods", {
        "metadata": {"name": "p"}, "status": {"phase": "Succeeded"}}))
    # a custom resource's status PUT cannot replace its spec
    r.call("crd", lambda: admin.create("customresourcedefinitions", {
        "metadata": {"name": "widgets.x.dev"},
        "spec": {"group": "x.dev", "scope": "Namespaced",
                 "names": {"plural": "widgets", "kind": "Widget", "shortNames": ["wgt"]},
                 "versions": [{"name": "v1"}]}}, namespace=None))
    r.call("cr", lambda: admin.create("widgets", {"metadata": {"name": "w"},
                                                  "spec": {"size": 3}}))
    r.call("cr-status", lambda: admin.request(
        "PUT", "/apis/x.dev/v1/namespaces/default/widgets/w/status",
        {"metadata": {"name": "w"}, "spec": {"size": 99}, "status": {"ready": True}}))


# -- audit and token requests ------------------------------------------------------


def _audit_events(r: Run, audit) -> List[Dict]:
    keep = ("verb", "user", "resource", "name", "namespace", "code", "level", "groups",
            "subresource", "stage")
    return [{k: e.get(k) for k in keep if k in e} for e in audit.events()]


def scn_audit(r: Run) -> None:
    audit_mod, auth = r.k("server.audit"), r.k("server.auth")
    p = audit_mod.default_audit_policy()
    node = _user(r, "system:node:n1", "system:nodes")
    alice = _user(r, "alice", "system:authenticated")
    r.note("default-policy", [p.level_for(node, "get", "pods"),
                              p.level_for(node, "update", "pods"),
                              p.level_for(alice, "list", "events"),
                              p.level_for(alice, "list", "pods")])
    rule = audit_mod.AuditRule(level=audit_mod.LEVEL_NONE, users=("ci-bot",), groups=("ops",))
    r.note("rule-and", [rule.matches(_user(r, "ci-bot", "ops"), "get", "pods"),
                        rule.matches(_user(r, "ci-bot", "dev"), "get", "pods"),
                        rule.matches(_user(r, "x", "ops"), "get", "pods")])
    pol = audit_mod.AuditPolicy(rules=[audit_mod.AuditRule(level=audit_mod.LEVEL_NONE,
                                                           verbs=("get",)),
                                       audit_mod.AuditRule(level="Metadata")])
    r.note("first-match", [pol.level_for(_user(r, "u"), "get", "pods"),
                           pol.level_for(_user(r, "u"), "create", "pods")])
    audit = audit_mod.AuditLogger(policy=audit_mod.AuditPolicy())
    authn = auth.TokenAuthenticator()
    authn.add("t-u", "alice")
    authn.add("t-w", "watcher")
    authz = (auth.RBACAuthorizer().grant("alice", ["*"], ["*"])
             .grant("watcher", ["get", "list"], ["pods"]))
    srv = r.server(authenticator=authn, authorizer=authz, audit=audit)
    c, w = r.client(srv, token="t-u"), r.client(srv, token="t-w")
    r.call("create", lambda: c.create("pods", copy.deepcopy(CPOD)))
    r.call("missing", lambda: c.get("pods", "nope"))
    r.call("crd", lambda: c.create("customresourcedefinitions", {
        "metadata": {"name": "widgets.x.dev"},
        "spec": {"group": "x.dev", "scope": "Namespaced",
                 "names": {"plural": "widgets", "kind": "Widget", "shortNames": ["wgt"]},
                 "versions": [{"name": "v1"}]}}, namespace=None))
    r.call("alias-list", lambda: c.request("GET", "/apis/x.dev/v1/namespaces/default/wgt"))
    r.call("denied-watch", lambda: w.request("GET", "/api/v1/namespaces/default/pods?watch=true"))
    r.note("events", _audit_events(r, audit))
    # the default logger on a default server records every workload request
    srv2 = r.server(audit="default")
    r.http(srv2, "POST", PODS, CPOD)
    r.http(srv2, "GET", PODS)
    r.note("default-events", _audit_events(r, srv2._httpd.audit))


def scn_audit_file_sink(r: Run) -> None:
    import os
    import tempfile

    audit_mod = r.k("server.audit")
    fd, path = tempfile.mkstemp(suffix=".log")
    os.close(fd)
    try:
        audit = audit_mod.AuditLogger(policy=audit_mod.AuditPolicy(), path=path)
        srv = r.server(audit=audit)
        r.client(srv).list("pods")
        srv.stop()
        audit.close()
        with open(path) as f:
            lines = [json.loads(line) for line in f.read().splitlines()]
        r.note("file", [{k: e.get(k) for k in ("verb", "resource", "code", "user")}
                        for e in lines])
    finally:
        os.unlink(path)


def scn_token_requests(r: Run) -> None:
    auth = r.k("server.auth")
    signer = auth.SignedTokenAuthenticator(b"k" * 32)
    srv = r.server(token_signer=signer)
    c = r.client(srv)
    path = "/api/v1/namespaces/default/serviceaccounts/{}/token"
    c.create("serviceaccounts", {"kind": "ServiceAccount", "metadata": {"name": "builder"}})
    out = r.call("mint", lambda: c.request("POST", path.format("builder"),
                                           {"spec": {"expirationSeconds": 1200}}))
    ident = signer.authenticate(f"Bearer {out['status']['token']}")
    r.note("ident", [ident.name, sorted(ident.groups)])
    r.call("ghost", lambda: c.request("POST", path.format("ghost"), {}))
    for bad in (0, -5):
        r.call(f"bad-{bad}", lambda: c.request("POST", path.format("builder"),
                                               {"spec": {"expirationSeconds": bad}}))
    for asked in (10, 10_000_000):
        out = r.call(f"clamp-{asked}", lambda: c.request(
            "POST", path.format("builder"), {"spec": {"expirationSeconds": asked}}))
        r.note(f"clamped-{asked}", out["status"]["expirationSeconds"])
    bare = r.server()
    bc = r.client(bare)
    bc.create("serviceaccounts", {"kind": "ServiceAccount", "metadata": {"name": "sa"}})
    r.call("unconfigured", lambda: bc.request("POST", path.format("sa"), {}))
    # minting needs its own grant on serviceaccounts/token
    authn = auth.TokenAuthenticator()
    authn.add("t-sa-admin", "sa-admin")
    authn.add("t-minter", "minter")
    authz = (auth.RBACAuthorizer()
             .grant("sa-admin", ["create", "get", "list"], ["serviceaccounts"])
             .grant("minter", ["create"], ["serviceaccounts/token"])
             .grant("minter", ["get", "list"], ["serviceaccounts"]))
    sec = r.server(authenticator=authn, authorizer=authz, token_signer=signer)
    sa_admin, minter = r.client(sec, token="t-sa-admin"), r.client(sec, token="t-minter")
    r.call("sa", lambda: sa_admin.create("serviceaccounts", {"kind": "ServiceAccount",
                                                             "metadata": {"name": "app"}}))
    r.call("admin-mint", lambda: sa_admin.request("POST", path.format("app"), {}))
    r.call("minter-mint", lambda: minter.request("POST", path.format("app"), {}))


# -- API Priority and Fairness --------------------------------------------------------


def scn_flow_classification(r: Run) -> None:
    fc_mod = r.k("server.flowcontrol")
    fc = fc_mod.default_flow_controller()
    auth = r.k("server.auth")

    def u(name, *groups):
        return auth.UserInfo(name=name, groups=tuple(groups) + ("system:authenticated",))

    r.note("bootstrap", [fc.classify(u("admin", "system:masters"), "create", "pods").name,
                         fc.classify(u("system:node:n1", "system:nodes"), "update",
                                     "pods").name,
                         fc.classify(u("sched", "system:kube-scheduler"), "bind", "pods").name,
                         fc.classify(u("alice"), "list", "pods").name,
                         fc.classify(None, "get", "pods").name])
    fc2 = fc_mod.FlowController(
        [fc_mod.PriorityLevel("a", seats=1), fc_mod.PriorityLevel("b", seats=1)],
        [fc_mod.FlowSchema("writes", "a", verbs=("create", "update")),
         fc_mod.FlowSchema("catch-all", "b")])
    r.note("first-match", [fc2.classify(u("u"), "create", "pods").name,
                           fc2.classify(u("u"), "get", "pods").name])
    for label, levels, schemas in (
            ("unknown-level", [fc_mod.PriorityLevel("a")], [fc_mod.FlowSchema("s", "missing")]),
            ("no-catch-all", [fc_mod.PriorityLevel("a")], []),
            ("filtered-last", [fc_mod.PriorityLevel("a")],
             [fc_mod.FlowSchema("writes", "a", verbs=("create",))])):
        try:
            fc_mod.FlowController(levels, schemas)
            r.note(label, "built")
        except ValueError as e:
            r.note(label, ["ValueError", str(e)])
    lvl = fc_mod.PriorityLevel("t", seats=1, queue_length=1, queue_timeout=0.2)
    got = [lvl.acquire(), lvl.acquire()]
    r.note("queue-timeout", [got, lvl.stats()])
    lvl.release()
    r.note("after-release", lvl.acquire())
    lvl = fc_mod.PriorityLevel("t", seats=1, queue_length=0, queue_timeout=5.0)
    t0 = time.monotonic()
    r.note("overflow", [lvl.acquire(), lvl.acquire(), time.monotonic() - t0 < 1.0])
    lvl = fc_mod.PriorityLevel("t", seats=1, queue_length=5, queue_timeout=5.0)
    lvl.acquire()
    waited: List[bool] = []
    th = threading.Thread(target=lambda: waited.append(lvl.acquire()))
    th.start()
    time.sleep(0.05)
    lvl.release()
    th.join(timeout=5)
    r.note("waiter", waited)
    ex = fc_mod.PriorityLevel("x", seats=0, exempt=True)
    r.note("exempt", [ex.acquire() for _ in range(5)])


def _take(level) -> None:
    """Hold a level's only seat: a request frees its seat after its response
    is out, so wait for the level to drain first (a failed acquire would
    count as a rejection)."""
    assert wait(lambda: level.stats()["inflight"] == 0, 5)
    assert level.acquire()


def scn_flow_server(r: Run) -> None:
    fc_mod, auth = r.k("server.flowcontrol"), r.k("server.auth")
    authn = auth.TokenAuthenticator()
    authn.add("t-user", "alice")
    authn.add("t-admin", "admin", ["system:masters"])
    fc = fc_mod.FlowController(
        [fc_mod.PriorityLevel("exempt", exempt=True),
         fc_mod.PriorityLevel("tiny", seats=1, queue_length=0),
         fc_mod.PriorityLevel("slow", seats=1, queue_length=0)],
        [fc_mod.FlowSchema("exempt", "exempt", users=(), groups=("system:masters",)),
         fc_mod.FlowSchema("heavy-lists", "slow", verbs=("list",)),
         fc_mod.FlowSchema("catch-all", "tiny")])
    srv = r.server(authenticator=authn, flowcontrol=fc)
    alice, admin = r.client(srv, token="t-user"), r.client(srv, token="t-admin")
    assert fc.levels["slow"].acquire()
    r.call("list-saturated", lambda: alice.list("pods"))
    r.call("named-get", lambda: alice.get("pods", "nope"))
    fc.levels["slow"].release()
    _take(fc.levels["tiny"])
    r.call("get-saturated", lambda: alice.get("pods", "nope"))
    r.call("admin", lambda: admin.list("pods"))
    r.call("healthz", lambda: admin.request("GET", "/healthz"))
    r.call("post-watch", lambda: alice.request(
        "POST", "/api/v1/namespaces/default/pods?watch=true",
        {"metadata": {"name": "p"}, "spec": {"containers": [{"name": "c"}]}}))
    # a 429 drains its body: the same keep-alive connection parses the next
    import http.client

    host, port = srv._httpd.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=10)
    conn.request("POST", PODS, b'{"metadata": {"name": "p"}, "spec": {"containers": []}}',
                 {"Authorization": "Bearer t-user", "Content-Type": "application/json"})
    resp = conn.getresponse()
    first = resp.status
    resp.read()
    fc.levels["tiny"].release()
    conn.request("GET", PODS, headers={"Authorization": "Bearer t-user"})
    resp = conn.getresponse()
    r.note("keep-alive", [first, resp.status])
    resp.read()
    conn.close()
    # a collection watch bypasses the seats
    _take(fc.levels["tiny"])
    seen: List[str] = []

    def consume():
        for et, _obj in alice.watch("pods", since_rv=0):
            seen.append(et)
            return

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    time.sleep(0.2)
    fc.levels["tiny"].release()
    alice.create("pods", {"metadata": {"name": "w"}, "spec": {"containers": [{"name": "c"}]}})
    th.join(timeout=10)
    r.note("watch", seen)
    wait(lambda: all(s["inflight"] == 0 for s in fc.stats().values()), 5)
    r.note("stats", fc.stats())


def scn_flow_objects(r: Run) -> None:
    fca, fc_mod, auth = r.k("api.flowcontrolapi"), r.k("server.flowcontrol"), r.k("server.auth")
    plc = fca.PriorityLevelConfiguration.from_dict({
        "metadata": {"name": "batch"},
        "spec": {"type": "Limited", "limited": {"seats": 3, "queueLength": 7,
                                                "queueTimeoutSeconds": 2.5}}})
    lvl = plc.to_level()
    r.note("to_level", [type(lvl).__name__, lvl.name, lvl.seats, lvl.queue_length,
                        lvl.queue_timeout, lvl.exempt])
    fsc = fca.FlowSchemaConfiguration.from_dict({
        "metadata": {"name": "heavy"},
        "spec": {"priorityLevelConfiguration": {"name": "batch"}, "matchingPrecedence": 100,
                 "verbs": ["list"], "resources": ["pods"]}})
    sch = fsc.to_schema()
    r.note("to_schema", [type(sch).__name__, sch.name, sch.level, sch.verbs, sch.resources,
                         sch.users, sch.groups])
    r.note("zero-queue", fca.PriorityLevelConfiguration.from_dict({
        "metadata": {"name": "t"},
        "spec": {"type": "Limited", "limited": {"seats": 1, "queueLength": 0}}}).queue_length)
    authn = auth.TokenAuthenticator()
    authn.add("t-u", "alice")
    srv = r.server(authenticator=authn, flowcontrol="default")
    alice = r.client(srv, token="t-u")
    r.call("bootstrap-list", lambda: alice.list("pods"))
    alice.create("prioritylevelconfigurations", {
        "kind": "PriorityLevelConfiguration", "metadata": {"name": "tiny"},
        "spec": {"type": "Limited", "limited": {"seats": 1, "queueLength": 0,
                                                "queueTimeoutSeconds": 0.2}}}, namespace=None)
    for name, prec, extra in (("lists", 10, {"verbs": ["list"], "resources": ["pods"]}),
                              ("catch-all", 9999, {})):
        alice.create("flowschemas", {"kind": "FlowSchema", "metadata": {"name": name},
                                     "spec": {"priorityLevelConfiguration": {"name": "tiny"},
                                              "matchingPrecedence": prec, **extra}},
                     namespace=None)
    fc = srv._httpd.flowcontrol
    level = fc.classify(None, "list", "pods")
    r.note("live-level", [level.name, level.seats])
    assert level.acquire()
    r.call("live-429", lambda: alice.list("pods"))
    level.release()
    r.call("live-ok", lambda: alice.list("pods"))
    alice.delete("flowschemas", "lists", namespace=None)
    alice.delete("flowschemas", "catch-all", namespace=None)
    r.note("fallback", fc.classify(None, "list", "pods").name)

    def u(name, *groups):
        return auth.UserInfo(name=name, groups=tuple(groups) + ("system:authenticated",))

    store = r.store()
    store.create("prioritylevelconfigurations", fca.PriorityLevelConfiguration.from_dict({
        "metadata": {"name": "tiny"},
        "spec": {"type": "Limited", "limited": {"seats": 1, "queueLength": 0}}}))
    store.create("flowschemas", fca.FlowSchemaConfiguration.from_dict({
        "metadata": {"name": "workload"},
        "spec": {"priorityLevelConfiguration": {"name": "tiny"}, "matchingPrecedence": 100,
                 "verbs": ["list"]}}))
    src = fc_mod.FlowConfigSource(store, fc_mod.default_flow_controller())
    r.note("mandatory", [src.classify(u("admin", "system:masters"), "list", "pods").name,
                         src.classify(u("n", "system:nodes"), "update", "pods").name,
                         src.classify(u("alice"), "list", "pods").name,
                         src.classify(u("alice"), "create", "pods").exempt])
    store2 = r.store()
    src2 = fc_mod.FlowConfigSource(store2, fc_mod.default_flow_controller())
    store2.create("prioritylevelconfigurations", fca.PriorityLevelConfiguration.from_dict({
        "metadata": {"name": "free"}, "spec": {"type": "Exempt"}}))
    store2.create("flowschemas", fca.FlowSchemaConfiguration.from_dict({
        "metadata": {"name": "exempt"},
        "spec": {"priorityLevelConfiguration": {"name": "free"}, "verbs": ["list"]}}))
    r.note("exempt-only", src2.classify(u("alice"), "create", "pods").exempt)


def scn_flow_metrics(r: Run) -> None:
    from test_torch_server import metric_families

    auth = r.k("server.auth")
    authn = auth.TokenAuthenticator()
    authn.add("t-admin", "admin", ["system:masters"])
    srv = r.server(authenticator=authn,
                   flowcontrol=r.k("server.flowcontrol").default_flow_controller())
    admin = r.client(srv, token="t-admin")
    admin.list("pods")
    text = admin.request_text("/metrics")
    r.note("apf-lines", sorted(line for line in text.splitlines()
                               if line.startswith("apiserver_flowcontrol_")))
    r.note("families", {k: v for k, v in metric_families(text).items()
                        if k.startswith("apiserver_")})


# -- server-side apply ---------------------------------------------------------------


def deploy(replicas=1, image="app:v1"):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "web", "namespace": "default", "labels": {"app": "web"}},
            "spec": {"replicas": replicas, "template": {"spec": {"containers": [
                {"name": "main", "image": image}]}}}}


def scn_field_manager(r: Run) -> None:
    fm = r.k("server.fieldmanager")

    def attempt(label: str, fn: Callable[[], Any]) -> Any:
        try:
            out = fn()
        except fm.Conflict as e:
            r.note(label, ["Conflict", sorted(e.conflicts), str(e)])
            return None
        r.note(label, out)
        return out

    r.note("fields", sorted(map(list, fm.fields_of(deploy()))))
    r.note("identity", sorted(fm.fields_of({"apiVersion": "v1", "kind": "Pod",
                                            "metadata": {"name": "p", "namespace": "ns",
                                                         "resourceVersion": 5},
                                            "status": {"phase": "Running"}})))
    r.note("atomic", sorted(map(list, fm.fields_of({"spec": {"nodeSelectorTerms": ["a"]}}))))
    s = fm.fields_of(deploy())
    r.note("v1", [fm.to_fields_v1(s), fm.from_fields_v1(fm.to_fields_v1(s)) == s])
    live = attempt("create", lambda: fm.apply_patch(None, deploy(), "alice"))
    attempt("conflict", lambda: fm.apply_patch(live, deploy(replicas=3), "bob"))
    attempt("coown", lambda: fm.apply_patch(
        fm.apply_patch(None, deploy(replicas=2), "alice"), deploy(replicas=2), "bob"))
    attempt("force", lambda: fm.apply_patch(live, deploy(replicas=3), "bob", force=True))
    second = deploy()
    del second["metadata"]["labels"]
    attempt("drop", lambda: fm.apply_patch(live, second, "alice"))
    lv = fm.apply_patch(None, deploy(replicas=2), "alice")
    lv = fm.apply_patch(lv, {"apiVersion": "apps/v1", "kind": "Deployment",
                             "metadata": {"name": "web"}, "spec": {"replicas": 2}}, "bob")
    third = deploy(replicas=2)
    del third["spec"]["replicas"]
    attempt("drop-coowned", lambda: fm.apply_patch(lv, third, "alice"))
    attempt("unmentioned", lambda: fm.apply_patch(live, {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "web", "annotations": {"note": "hi"}}}, "bob"))
    base = deploy()
    base["spec"]["template"]["spec"]["containers"].append({"name": "sidecar", "image": "s:1"})
    lv = fm.apply_patch(None, base, "alice")
    attempt("keyed-merge", lambda: fm.apply_patch(lv, {
        "apiVersion": "apps/v1", "kind": "Deployment", "metadata": {"name": "web"},
        "spec": {"template": {"spec": {"containers": [{"name": "sidecar",
                                                        "image": "s:2"}]}}}},
        "bob", force=True))
    attempt("keyed-remove", lambda: fm.apply_patch(lv, deploy(), "alice"))
    after = json.loads(json.dumps(lv))
    after["spec"]["template"]["spec"]["containers"][1]["image"] = "s:2"
    after["metadata"]["managedFields"] = fm.capture_update(lv, after, "bob")
    attempt("keyed-foreign", lambda: fm.apply_patch(after, deploy(), "alice"))
    created = deploy(replicas=4)
    lv = dict(created)
    lv["metadata"] = dict(created["metadata"])
    lv["metadata"]["managedFields"] = fm.capture_update(None, created, "ktl")
    attempt("takeover", lambda: fm.apply_patch(lv, {
        "apiVersion": "apps/v1", "kind": "Deployment", "metadata": {"name": "web"},
        "spec": {"replicas": 9}}, "ktl"))
    after = json.loads(json.dumps(live))
    after["spec"]["replicas"] = 5
    r.note("capture-moves", fm.capture_update(live, after, "scaler"))
    after = json.loads(json.dumps(live))
    del after["metadata"]["labels"]
    r.note("capture-removes", fm.capture_update(live, after, "editor"))


def scn_apply_http(r: Run) -> None:
    srv = r.server()
    c = r.client(srv)
    cm = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cm"}, "data": {"k": "1"}}
    r.call("alice", lambda: c.apply("configmaps", "cm", cm, "default", field_manager="alice"))
    cm2 = dict(cm, data={"k": "2"})
    r.call("bob", lambda: c.apply("configmaps", "cm", cm2, "default", field_manager="bob"))
    r.call("bob-force", lambda: c.apply("configmaps", "cm", cm2, "default",
                                        field_manager="bob", force=True))
    doc = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cm2"},
           "data": {"a": "1", "b": "2"}}
    r.call("create", lambda: c.apply("configmaps", "cm2", doc, "default", field_manager="alice"))
    r.call("prune", lambda: c.apply("configmaps", "cm2", dict(doc, data={"a": "1"}), "default",
                                    field_manager="alice"))
    r.call("no-manager", lambda: c.apply("configmaps", "cm3", dict(doc, metadata={
        "name": "cm3"}), "default", field_manager=""))
    doc4 = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "cm4"},
            "data": {"k": "1", "j": "x"}}
    c.apply("configmaps", "cm4", doc4, "default", field_manager="alice")
    live = c.get("configmaps", "cm4")
    live["data"]["k"] = "9"
    r.call("put-editor", lambda: c.request(
        "PUT", "/api/v1/namespaces/default/configmaps/cm4?fieldManager=editor", live))
    r.call("reapply", lambda: c.apply("configmaps", "cm4", doc4, "default",
                                      field_manager="alice"))
    for label, path, body in (
            ("unknown", "/api/v1/namespaces/default/bogusthings/x?fieldManager=m",
             {"metadata": {"name": "x"}}),
            ("bad-meta", "/api/v1/namespaces/default/configmaps/x?fieldManager=m",
             {"metadata": "bogus"})):
        r.call(label, lambda: c.request("PATCH", path, body,
                                        content_type="application/apply-patch+yaml"))
    c.apply("configmaps", "cm5", {"apiVersion": "v1", "kind": "ConfigMap",
                                  "metadata": {"name": "cm5"}, "data": {"k": "1"}},
            "default", field_manager="alice")
    r.call("forge", lambda: c.patch("configmaps", "cm5", {"metadata": {"managedFields": [
        {"manager": "evil", "operation": "Apply", "fieldsType": "FieldsV1",
         "fieldsV1": {"f:data": {"f:k": {}}}}]}}, "default"))
    r.call("apply-deploy", lambda: c.apply("deployments", "web", deploy(), "default",
                                           field_manager="alice"))
    r.call("apply-pod", lambda: c.apply("pods", "ap", {
        "kind": "Pod", "metadata": {"name": "ap", "namespace": "default", "labels": {"v": "2"}},
        "spec": {"containers": [{"name": "c0"}]}}, "default", field_manager="ktl"))


# -- the aggregation layer --------------------------------------------------------------


class _Extension(BaseHTTPRequestHandler):
    """A fake extension apiserver recording what reaches it."""

    def _serve(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else b""
        self.server.seen.append({  # type: ignore[attr-defined]
            "method": self.command, "path": self.path,
            "user": self.headers.get("X-Remote-User", ""), "body": body.decode() or None})
        if self.path.endswith("/healthz"):
            payload = b"ok"
            self.send_response(200)
        elif "boom" in self.path:
            payload = json.dumps({"message": "boom"}).encode()
            self.send_response(418)
        else:
            payload = json.dumps({"kind": "WidgetList", "served": self.path,
                                  "echo": body.decode() or None}).encode()
            self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    do_GET = do_POST = do_PUT = do_DELETE = _serve

    def log_message(self, *a):
        pass


def _http_backend(r: Run, handler) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    httpd.seen = []  # type: ignore[attr-defined]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    state = {"up": True}

    def halt():
        if state["up"]:
            state["up"] = False
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=5)

    httpd.halt = halt  # type: ignore[attr-defined]
    r.on_close(halt)
    return httpd


def scn_aggregation(r: Run) -> None:
    APIService = r.k("api.apiservice").APIService
    ext = _http_backend(r, _Extension)
    url = f"http://127.0.0.1:{ext.server_address[1]}"
    srv = r.server()
    store = srv.store
    store.create("apiservices", APIService(group="widgets.example.com", service_url=url,
                                           available=True))
    alice, c = r.client(srv, user="alice"), r.client(srv)
    base = "/apis/widgets.example.com/v1"
    r.call("get", lambda: alice.request("GET", f"{base}/namespaces/default/widgets"))
    r.call("post", lambda: c.request("POST", f"{base}/namespaces/default/widgets",
                                     {"kind": "Widget", "metadata": {"name": "w1"}}))
    r.call("boom", lambda: c.request("GET", f"{base}/boom"))
    store.create("apiservices", APIService(group="apps", service_url=url, available=True))
    r.call("builtin", lambda: c.list("deployments"))
    store.create("apiservices", APIService(group="down.example.com", service_url=url,
                                           available=False))
    r.call("unavailable", lambda: c.request("GET", "/apis/down.example.com/v1/widgets"))
    store.create("apiservices", APIService(group="gone.example.com",
                                           service_url="http://127.0.0.1:9", available=True))
    r.call("unreachable", lambda: c.request("GET", "/apis/gone.example.com/v1/things"))
    store.create("apiservices", APIService(group="metrics.example.com", version="v1",
                                           service_url=url, available=True,
                                           group_priority_minimum=100))
    store.create("apiservices", APIService(group="metrics.example.com", version="v2",
                                           service_url="http://127.0.0.1:9", available=True,
                                           group_priority_minimum=9000))
    r.call("version-v1", lambda: c.request("GET", "/apis/metrics.example.com/v1/nodes"))
    r.call("version-v2", lambda: c.request("GET", "/apis/metrics.example.com/v2/nodes"))
    store.create("apiservices", APIService(group="crd.example.com", service_url=url,
                                           available=True))
    c.create("customresourcedefinitions", {
        "kind": "CustomResourceDefinition", "metadata": {"name": "gadgets.crd.example.com"},
        "spec": {"group": "crd.example.com", "names": {"plural": "gadgets", "kind": "Gadget"},
                 "scope": "Namespaced",
                 "versions": [{"name": "v1", "served": True, "storage": True}]}}, namespace=None)
    r.call("crd-post", lambda: c.request("POST", "/apis/crd.example.com/v1/namespaces/default/"
                                                 "gadgets",
                                         {"apiVersion": "crd.example.com/v1", "kind": "Gadget",
                                          "metadata": {"name": "g1"}}))
    r.call("crd-get", lambda: c.request(
        "GET", "/apis/crd.example.com/v1/namespaces/default/gadgets/g1"))
    r.note("seen", ext.seen)
    # the availability controller probes the backend's /healthz
    svc = APIService(group="probe.example.com", service_url=url, available=False)
    store.create("apiservices", svc)
    ctl = r.k("controllers").APIServiceAvailabilityController(store)
    ctl.sync_all()
    ctl.run_until_stable()
    got = store.get("apiservices", svc.metadata.name)
    r.note("probed", [got.available, got.available_message])
    ext.halt()
    ctl._mark(svc.metadata.name)
    ctl.process()
    got = store.get("apiservices", svc.metadata.name)
    r.note("down", [got.available, "unreachable" in got.available_message])


def scn_aggregation_auth_and_watch(r: Run) -> None:
    auth = r.k("server.auth")
    APIService = r.k("api.apiservice").APIService
    ext = _http_backend(r, _Extension)
    store = r.store()
    authn = auth.TokenAuthenticator()
    authn.add("good-token", "alice")
    srv = r.server(store, authenticator=authn, authorizer=auth.default_component_authorizer())
    store.create("apiservices", APIService(
        group="widgets.example.com", service_url=f"http://127.0.0.1:{ext.server_address[1]}",
        available=True))
    anon, alice = r.client(srv), r.client(srv, token="good-token")
    r.call("anon", lambda: anon.request("GET", "/apis/widgets.example.com/v1/widgets"))
    r.call("read", lambda: alice.request("GET", "/apis/widgets.example.com/v1/widgets"))
    r.call("write", lambda: alice.request("POST", "/apis/widgets.example.com/v1/widgets",
                                          {"kind": "Widget"}))
    r.note("seen", ext.seen)
    # a watch through the proxy streams each event as the backend sends it
    release = threading.Event()

    class _Streamer(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def send(i):
                line = json.dumps({"type": "ADDED", "object": {
                    "metadata": {"name": f"w{i}"}}}).encode() + b"\n"
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                self.wfile.flush()

            send(0)
            release.wait(timeout=10)
            send(1)
            send(2)
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, *a):
            pass

    backend = _http_backend(r, _Streamer)
    r.on_close(release.set)
    open_srv = r.server()
    open_srv.store.create("apiservices", APIService(
        group="streams.example.com",
        service_url=f"http://127.0.0.1:{backend.server_address[1]}", available=True))
    conn, resp = open_stream(open_srv, "/apis/streams.example.com/v1/widgets?watch=true")
    try:
        first = read_frames(resp, lambda f: len(f) >= 1)
        release.set()
        rest = read_frames(resp, lambda f: False, timeout=5)
        r.note("streamed", [[f.get("type"), (f.get("object") or {}).get("metadata")]
                            for f in first + rest])
    finally:
        conn.close()


SCENARIOS = {
    "token_authn_and_rbac": scn_token_authn_and_rbac,
    "status_subresource_authz": scn_status_subresource_authz,
    "audit": scn_audit,
    "audit_file_sink": scn_audit_file_sink,
    "token_requests": scn_token_requests,
    "flow_classification": scn_flow_classification,
    "flow_server": scn_flow_server,
    "flow_objects": scn_flow_objects,
    "flow_metrics": scn_flow_metrics,
    "field_manager": scn_field_manager,
    "apply_http": scn_apply_http,
    "aggregation": scn_aggregation,
    "aggregation_auth_and_watch": scn_aggregation_auth_and_watch,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_auth_parity(name):
    twin(SCENARIOS[name])

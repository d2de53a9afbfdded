"""The port's API server held against the JAX package's, request by request.

Each scenario below is one seeded request sequence. `twin(scenario)` runs it
once on each package (a fresh store and an `APIServer` on port 0 for each,
`kubernetes_tpu` first, then `kubernetes_tpu_torch`), records what the client
saw (status codes, bodies, watch frames, and the values the scenario notes),
normalizes only what differs between two processes' servers by nature (uids
by their mint order, timestamps, URLs and ports, signed tokens, latency
sums) and asserts the two transcripts equal. The scenarios cover the
server-side cases of the JAX package's REST, watch-list, watch-mux, patch,
status-subresource, field-selector, exec and /debug tests; the admission,
auth, audit, flow-control, SSA and aggregation cases are in
test_torch_server_admission.py and test_torch_server_auth.py, which import
this harness.

Every socket has a timeout and every wait a deadline (`wait`): the suite
assumes no pytest timeout plugin. Every server a scenario starts is stopped by the
harness, and `assert_no_thread_leaks` checks that nothing stays behind.
"""

from __future__ import annotations

import http.client
import importlib
import json
import re
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import pytest

JAX, PORT = "kubernetes_tpu", "kubernetes_tpu_torch"

# keys whose values are wall-clock stamps or durations in either package
TIME_KEYS = frozenset({
    "creationTimestamp", "deletionTimestamp", "lastTransitionTime",
    "lastHeartbeatTime", "lastUpdateTime", "lastProbeTime", "firstTimestamp",
    "lastTimestamp", "eventTime", "renewTime", "acquireTime", "startTime",
    "completionTime", "expirationTimestamp", "requestReceivedTimestamp",
    "stageTimestamp", "ts", "timestamp", "time", "started", "started_at",
    "t", "t0", "t1", "age_s", "oldest_pending_age_s", "latency_ms",
    "duration_s", "elapsed_s", "wall_s", "sum_s", "sum",
})
_URL = re.compile(r"http://127\.0\.0\.1:\d+")
_TOKEN = re.compile(r"ktpu\.v1\.[A-Za-z0-9_\-=]+\.[0-9a-f]+")


def wait(pred: Callable[[], Any], timeout: float = 10.0, step: float = 0.02):
    """Poll pred until it is truthy or the deadline passes; returns its
    last value (every wait of these tests has its own deadline)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(step)
    return pred()


class Pkg:
    """One package's modules by relative name: `k("server.rest")`."""

    def __init__(self, root: str):
        self.root = root

    def __call__(self, mod: str):
        return importlib.import_module(f"{self.root}.{mod}")

    @property
    def is_port(self) -> bool:
        return self.root == PORT


class Run:
    """One package's run of a scenario: its servers, its transcript."""

    def __init__(self, k: Pkg):
        self.k = k
        self.log: List[Any] = []
        self._stops: List[Callable[[], None]] = []

    # -- building ------------------------------------------------------------

    def store(self, **kw):
        return self.k("store").APIStore(**kw)

    def server(self, store=None, **kw):
        srv = self.k("server.rest").APIServer(
            store if store is not None else self.store(), **kw).start()
        self._stops.append(srv.stop)
        return srv

    def client(self, srv, **kw):
        kw.setdefault("timeout", 10.0)
        return self.k("server.client").RESTClient(srv.url, **kw)

    def on_close(self, fn: Callable[[], None]) -> None:
        self._stops.append(fn)

    def close(self) -> None:
        while self._stops:
            fn = self._stops.pop()
            try:
                fn()
            except Exception:  # noqa: BLE001 - teardown must reach every stop
                pass

    # -- recording -----------------------------------------------------------

    def note(self, label: str, value: Any) -> Any:
        self.log.append([label, value])
        return value

    def http(self, srv, method: str, path: str, body: Any = None,
             headers: Optional[Dict[str, str]] = None, label: str = "",
             raw: Optional[bytes] = None, record: bool = True):
        """One request over a fresh connection; returns (status, parsed
        body) and records both (JSON bodies parsed, others as text)."""
        host, port = srv._httpd.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=10)
        hdrs = dict(headers or {})
        data = raw
        if body is not None:
            data = json.dumps(body).encode()
            hdrs.setdefault("Content-Type", "application/json")
        try:
            conn.request(method, path, body=data, headers=hdrs)
            resp = conn.getresponse()
            text = resp.read().decode("utf-8", "replace")
            status = resp.status
        finally:
            conn.close()
        try:
            parsed = json.loads(text) if text else None
        except ValueError:
            parsed = text
        if record:
            self.log.append([label or f"{method} {path}", status, parsed])
        return status, parsed

    def call(self, label: str, fn: Callable[[], Any]) -> Any:
        """Run a client call; record its result or its APIError's code."""
        err = self.k("server.client").APIError
        try:
            out = fn()
        except err as e:
            self.log.append([label, "APIError", e.code, str(e)])
            return None
        self.log.append([label, out])
        return out


def open_stream(srv, path: str, timeout: float = 10.0):
    """A raw watch stream: (connection, response) with a socket timeout."""
    host, port = srv._httpd.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("GET", path)
    return conn, conn.getresponse()


def read_frames(resp, until: Callable[[List[Dict]], bool],
                timeout: float = 10.0, skip_bookmarks: bool = False) -> List[Dict]:
    """Read newline-delimited watch frames until `until(frames)` or EOF or
    the deadline."""
    frames: List[Dict] = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            line = resp.readline()
        except (socket.timeout, OSError):
            break
        if line == b"":
            frames.append({"type": "EOF"})
            break
        if not line.strip():
            continue
        ev = json.loads(line)
        if skip_bookmarks and ev.get("type") == "BOOKMARK":
            continue
        frames.append(ev)
        if until(frames):
            break
    return frames


def frame_summary(frames: List[Dict]) -> List[List[Any]]:
    out = []
    for ev in frames:
        meta = (ev.get("object") or {}).get("metadata") or {}
        out.append([ev.get("type"), meta.get("name"), meta.get("resourceVersion"),
                    (meta.get("annotations") or {}).get("k8s.io/initial-events-end")])
    return out


# -- normalization -----------------------------------------------------------


def _walk(x: Any) -> Any:
    if isinstance(x, dict):
        out = {}
        for key, val in x.items():
            if key in TIME_KEYS and isinstance(val, (int, float, str)) and val not in ("", None):
                out[key] = "<t>"
            else:
                out[key] = _walk(val)
        return out
    if isinstance(x, list):
        return [_walk(v) for v in x]
    if isinstance(x, str):
        return _TOKEN.sub("<token>", _URL.sub("<url>", x))
    return x


def normalize(log: List[Any], k: Pkg) -> Any:
    """A run's transcript in comparable form: uids by mint order (the
    package's own session), then timestamps, URLs and tokens."""
    text = json.dumps(log, sort_keys=True, default=str)
    text = Pkg(PORT)("testing").normalize_uids(text, k("api.types")._uid_session)
    return _walk(json.loads(text))


def run_one(root: str, scenario: Callable[[Run], None]) -> Any:
    run = Run(Pkg(root))
    try:
        scenario(run)
    finally:
        run.close()
    return normalize(run.log, run.k)


def twin(scenario: Callable[[Run], None]) -> Any:
    """Run `scenario` on the JAX package, then on the port; assert the
    normalized transcripts equal and return the port's."""
    from kubernetes_tpu_torch.utils.leakcheck import assert_no_thread_leaks

    with assert_no_thread_leaks(grace=5.0):
        want = run_one(JAX, scenario)
        got = run_one(PORT, scenario)
    assert want, "the scenario recorded nothing"
    if got != want:
        for i, (a, b) in enumerate(zip(want, got)):
            assert a == b, f"first difference at entry {i}:\nJAX:  {a}\nport: {b}"
        assert len(got) == len(want), (len(want), len(got))
    return got


# -- fixtures of the scenarios -------------------------------------------------


def pod(name: str, ns: str = "default", labels: Optional[Dict] = None,
        cpu: str = "", node: str = "", **spec) -> Dict:
    c: Dict[str, Any] = {"name": "c", "image": "busybox"}
    if cpu:
        c["resources"] = {"requests": {"cpu": cpu}}
    body = {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns, "labels": labels or {}},
            "spec": {"containers": [c], **spec}}
    if node:
        body["spec"]["nodeName"] = node
    return body


def node(name: str, cpu: str = "8", labels: Optional[Dict] = None) -> Dict:
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels or {}},
            "status": {"capacity": {"cpu": cpu, "memory": "16Gi", "pods": "110"},
                       "allocatable": {"cpu": cpu, "memory": "16Gi", "pods": "110"}}}


PODS = "/api/v1/namespaces/default/pods"


# -- REST: CRUD, list, selectors, patch, status -------------------------------


def scn_crud(r: Run) -> None:
    srv = r.server()
    r.http(srv, "POST", "/api/v1/nodes", node("n0"))
    for i in range(4):
        r.http(srv, "POST", PODS, pod(f"p{i}", labels={"app": "a" if i % 2 else "b"}))
    r.http(srv, "POST", PODS, pod("p0"))                      # 409 AlreadyExists
    r.http(srv, "GET", f"{PODS}/p1")
    r.http(srv, "GET", f"{PODS}/ghost")                       # 404
    r.http(srv, "GET", PODS)
    r.http(srv, "GET", "/api/v1/pods")
    r.http(srv, "GET", "/api/v1/nodes")
    _, got = r.http(srv, "GET", f"{PODS}/p2")
    got["metadata"]["labels"]["v"] = "2"
    r.http(srv, "PUT", f"{PODS}/p2", got)
    r.http(srv, "PUT", f"{PODS}/p2", got)                     # stale RV: 409
    r.http(srv, "DELETE", f"{PODS}/p3")
    r.http(srv, "DELETE", f"{PODS}/p3")                       # 404
    r.http(srv, "GET", PODS)
    r.http(srv, "POST", f"{PODS}/p0/binding",
           {"kind": "Binding", "metadata": {"name": "p0"}, "target": {"name": "n0"}})
    r.http(srv, "POST", f"{PODS}/p0/binding",
           {"kind": "Binding", "metadata": {"name": "p0"}, "target": {"name": "n0"}})
    r.http(srv, "GET", f"{PODS}/p0")
    r.http(srv, "POST", "/api/v1/namespaces/default/nopes", {"metadata": {"name": "x"}})
    r.http(srv, "GET", "/nowhere")
    r.http(srv, "POST", PODS, raw=b"{not json", headers={"Content-Type": "application/json"})


def scn_selectors(r: Run) -> None:
    srv = r.server()
    for n in ("n0", "n1"):
        r.http(srv, "POST", "/api/v1/nodes", node(n, labels={"zone": n[-1]}))
    for i in range(6):
        r.http(srv, "POST", PODS, pod(f"p{i}", labels={"app": "web" if i < 3 else "db",
                                                       "tier": str(i % 2)},
                                      node="n0" if i % 3 == 0 else ""))
    for q in ("labelSelector=app%3Dweb", "labelSelector=app%21%3Dweb",
              "labelSelector=app+in+%28web%2Cdb%29%2Ctier%3D1",
              "labelSelector=%21tier", "labelSelector=tier",
              "labelSelector=a+in+%28%29",
              "fieldSelector=spec.nodeName%3Dn0", "fieldSelector=spec.nodeName%3D%3Dn0",
              "fieldSelector=spec.nodeName%21%3Dn0",
              "fieldSelector=metadata.name%3Dp4", "fieldSelector=spec.bogus%3Dx",
              "fieldSelector=status.phase%3DPending&labelSelector=app%3Ddb",
              "limit=2", "limit=2&continue=2"):
        r.http(srv, "GET", f"{PODS}?{q}")
    r.http(srv, "GET", "/api/v1/nodes?labelSelector=zone%3D1")


def scn_patch_and_status(r: Run) -> None:
    srv = r.server()
    r.http(srv, "POST", PODS, pod("p", cpu="1"))
    hdr = {"Content-Type": "application/merge-patch+json"}
    r.http(srv, "PATCH", f"{PODS}/p", {"metadata": {"labels": {"tier": "web"}}}, headers=hdr)
    r.http(srv, "PATCH", f"{PODS}/p", {"metadata": {"labels": {"tier": None, "x": "1"}}},
           headers=hdr)
    r.http(srv, "PATCH", f"{PODS}/ghost", {"metadata": {"labels": {"a": "b"}}}, headers=hdr)
    r.http(srv, "PATCH", f"{PODS}/p", {"spec": {"nodeName": "n9"}}, headers=hdr)
    # status subresource: PUT replaces only status, PATCH cannot touch spec
    _, cur = r.http(srv, "GET", f"{PODS}/p")
    cur["status"] = {"phase": "Running"}
    cur["spec"]["containers"][0]["image"] = "changed"
    r.http(srv, "PUT", f"{PODS}/p/status", cur)
    r.http(srv, "PUT", f"{PODS}/p/status", cur)              # stale body RV: 409
    r.http(srv, "PATCH", f"{PODS}/p/status",
           {"status": {"phase": "Succeeded"}, "spec": {"containers": [{"name": "z"}]}},
           headers=hdr)
    r.http(srv, "GET", f"{PODS}/p")
    r.http(srv, "GET", f"{PODS}/p/status")
    r.http(srv, "PATCH", f"{PODS}/p", raw=b"[1,2]", headers=hdr)
    jm = r.k("server.rest").json_merge_patch
    r.note("merge", jm({"a": {"b": 1, "c": 2}, "keep": "x", "lst": [1, 2]},
                       {"a": {"b": 9, "c": None}, "lst": [3], "new": True}))


def scn_discovery_and_health(r: Run) -> None:
    srv = r.server()
    for path in ("/healthz", "/readyz", "/version", "/apis", "/api",
                 "/api/v1", "/apis/apps/v1", "/openapi/v2"):
        r.http(srv, "GET", path)


def scn_crd(r: Run) -> None:
    srv = r.server()
    crd = {"apiVersion": "apiextensions.k8s.io/v1", "kind": "CustomResourceDefinition",
           "metadata": {"name": "widgets.example.com"},
           "spec": {"group": "example.com", "scope": "Namespaced",
                    "names": {"plural": "widgets", "singular": "widget", "kind": "Widget"},
                    "versions": [{"name": "v1", "served": True, "storage": True,
                                  "subresources": {"status": {}},
                                  "schema": {"openAPIV3Schema": {
                                      "type": "object", "properties": {
                                          "spec": {"type": "object", "required": ["size"],
                                                   "properties": {"size": {"type": "integer",
                                                                           "minimum": 1}}}}}}}]}}
    r.http(srv, "POST", "/apis/apiextensions.k8s.io/v1/customresourcedefinitions", crd)
    base = "/apis/example.com/v1/namespaces/default/widgets"
    r.http(srv, "POST", base, {"apiVersion": "example.com/v1", "kind": "Widget",
                               "metadata": {"name": "w1"}, "spec": {"size": 3}})
    r.http(srv, "POST", base, {"apiVersion": "example.com/v1", "kind": "Widget",
                               "metadata": {"name": "bad"}, "spec": {"size": 0}})
    r.http(srv, "POST", base, {"apiVersion": "example.com/v1", "kind": "Widget",
                               "metadata": {"name": "bad2"}, "spec": {}})
    r.http(srv, "GET", base)
    _, w = r.http(srv, "GET", f"{base}/w1")
    w["status"] = {"ready": True}
    w["spec"]["size"] = 99
    r.http(srv, "PUT", f"{base}/w1/status", w)
    r.http(srv, "GET", f"{base}/w1")
    r.http(srv, "PATCH", f"{base}/w1", {"spec": {"size": 5}},
           headers={"Content-Type": "application/merge-patch+json"})
    r.http(srv, "GET", "/apis")
    r.http(srv, "DELETE", f"{base}/w1")
    r.http(srv, "DELETE", "/apis/apiextensions.k8s.io/v1/customresourcedefinitions/"
                          "widgets.example.com")
    r.http(srv, "GET", base)


def _answering_agent(r: Run, store):
    """A stand-in for the node agent's exec and port-forward handlers
    (ROADMAP.md queue 1 item 7h): it answers every open session."""
    import copy

    stop = threading.Event()

    def loop():
        while not stop.is_set():
            for kind in ("podexecs", "podportforwards"):
                for sess in store.list(kind)[0]:
                    if sess.done:
                        continue
                    cur = copy.deepcopy(sess)
                    cur.done = True
                    if kind == "podexecs":
                        cur.stdout = "out:" + " ".join(cur.command)
                        cur.exit_code = 0
                    else:
                        cur.response = cur.data
                    try:
                        store.update(kind, cur)
                    except Exception:  # noqa: BLE001 - the session ended meanwhile
                        pass
            stop.wait(0.01)

    th = threading.Thread(target=loop, daemon=True)
    th.start()

    def halt():
        stop.set()
        th.join(timeout=5)

    r.on_close(halt)


def scn_exec_sessions(r: Run) -> None:
    store = r.store()
    srv = r.server(store)
    c = r.client(srv)
    r.http(srv, "POST", "/api/v1/nodes", node("n0"))
    r.http(srv, "POST", PODS, pod("p", node="n0"))
    r.http(srv, "POST", PODS, pod("pending"))
    r.call("exec-missing", lambda: c.exec("ghost", ["echo", "hi"]))
    r.http(srv, "POST", f"{PODS}/pending/exec", {"command": ["true"]}, label="unscheduled")
    r.http(srv, "POST", f"{PODS}/p/exec", {"command": []}, label="no-command")
    r.http(srv, "POST", f"{PODS}/p/exec", {"command": ["x"], "timeoutSeconds": "z"},
           label="bad-timeout")
    r.http(srv, "POST", f"{PODS}/p/exec", {"command": ["x"], "timeoutSeconds": 0.3},
           label="no-agent")
    _answering_agent(r, store)
    r.http(srv, "POST", f"{PODS}/p/exec", {"command": ["echo", "hi"], "container": "c"},
           label="exec")
    r.http(srv, "POST", f"{PODS}/p/attach", {}, label="attach")
    r.http(srv, "POST", f"{PODS}/p/portforward", {"port": 8080, "data": "aGVsbG8="},
           label="portforward")
    r.call("client-exec", lambda: c.exec("p", ["ls", "/"]))
    r.call("client-pf", lambda: c.port_forward("p", 80, b"ping"))
    r.note("sessions-left", [len(store.list(k)[0]) for k in ("podexecs", "podportforwards")])


def scn_events_and_bindings_over_client(r: Run) -> None:
    srv = r.server()
    c = r.client(srv)
    r.call("create-node", lambda: c.create("nodes", node("n0")))
    r.call("create", lambda: c.create("pods", pod("a")))
    r.call("list", lambda: c.list("pods"))
    r.call("get", lambda: c.get("pods", "a"))
    r.call("bind", lambda: c.bind("default", "a", "n0"))
    r.call("rebind", lambda: c.bind("default", "a", "n0"))
    r.call("patch", lambda: c.patch("pods", "a", {"metadata": {"labels": {"x": "y"}}}))
    r.call("evict", lambda: c.evict("a"))
    r.call("get-after", lambda: c.get("pods", "a"))
    r.call("list-ns", lambda: c.list("pods", namespace="default"))
    r.call("delete-missing", lambda: c.delete("pods", "nope"))


# -- watch: since_rv, bookmarks, watch-list, the mux ----------------------------


def scn_watch_since_rv(r: Run) -> None:
    store = r.store()
    srv = r.server(store)
    for i in range(3):
        r.http(srv, "POST", PODS, pod(f"pre{i}"))
    conn, resp = open_stream(srv, f"{PODS}?watch=true&resourceVersion=1")
    try:
        r.http(srv, "POST", PODS, pod("live"))
        r.http(srv, "DELETE", f"{PODS}/pre0")
        frames = read_frames(resp, lambda f: len(f) >= 4, skip_bookmarks=True)
        r.note("frames", frame_summary(frames))
        r.note("objects", [f.get("object") for f in frames])
    finally:
        conn.close()
    # a resume below the history floor is a 410
    small = r.store(history_limit=4)
    srv2 = r.server(small)
    for i in range(12):
        r.http(srv2, "POST", PODS, pod(f"h{i}"), record=False)
    conn, resp = open_stream(srv2, f"{PODS}?watch=true&resourceVersion=1")
    try:
        r.note("status-410", resp.status)
        r.note("gone", read_frames(resp, lambda f: len(f) >= 1, timeout=3))
    finally:
        conn.close()


def scn_watch_list(r: Run) -> None:
    store = r.store()
    srv = r.server(store)
    MakePod = r.k("testing").MakePod
    for i in range(3):
        store.create("pods", MakePod(f"pre-{i}").obj())
    conn, resp = open_stream(srv, f"{PODS}?watch=true&resourceVersion=-1&sendInitialEvents=true")
    try:
        frames = read_frames(resp, lambda f: f[-1]["type"] == "BOOKMARK" and (
            (f[-1]["object"].get("metadata") or {}).get("annotations") or {}).get(
                "k8s.io/initial-events-end") == "true")
        r.note("initial", frame_summary(frames))
        store.create("pods", MakePod("live").obj())
        frames = read_frames(resp, lambda f: f[-1]["type"] == "ADDED", skip_bookmarks=True)
        r.note("live", frame_summary(frames))
    finally:
        conn.close()


def scn_field_selector_watch(r: Run) -> None:
    store = r.store()
    srv = r.server(store)
    r.http(srv, "POST", "/api/v1/nodes", node("n1"))
    r.http(srv, "POST", "/api/v1/nodes", node("n2"))
    r.http(srv, "POST", PODS, pod("early", node="n1"))
    _, lst = r.http(srv, "GET", f"{PODS}?fieldSelector=spec.nodeName%3Dn1")
    rv = lst["metadata"]["resourceVersion"]
    conn, resp = open_stream(
        srv, f"{PODS}?watch=true&resourceVersion={rv}&fieldSelector=spec.nodeName%3Dn1")
    try:
        r.http(srv, "POST", PODS, pod("other", node="n2"))
        r.http(srv, "POST", PODS, pod("mine"))
        r.http(srv, "POST", f"{PODS}/mine/binding",
               {"kind": "Binding", "metadata": {"name": "mine"}, "target": {"name": "n1"}})
        r.http(srv, "DELETE", f"{PODS}/early")
        frames = read_frames(resp, lambda f: len(f) >= 2, skip_bookmarks=True)
        r.note("scoped", frame_summary(frames))
    finally:
        conn.close()
    r.http(srv, "GET", f"{PODS}?watch=true&fieldSelector=spec.bogus%3Dx")


def scn_watch_mux(r: Run) -> None:
    store = r.store()
    srv = r.server(store)
    MakePod = r.k("testing").MakePod
    _, rv = store.list("pods")
    streams = [open_stream(srv, f"{PODS}?watch=true&resourceVersion={rv}") for _ in range(20)]
    try:
        r.note("streams", bool(wait(lambda: srv._mux.stream_count == 20, 5)))
        for i in range(5):
            store.create("pods", MakePod(f"p{i}").obj())
        seen = []
        for conn, resp in streams:
            frames = read_frames(resp, lambda f: len(f) >= 5, skip_bookmarks=True)
            seen.append(frame_summary(frames))
        r.note("all-equal", all(s == seen[0] for s in seen))
        r.note("frames", seen[0])
    finally:
        for conn, _ in streams:
            conn.close()
    # a write after the clients closed reaps every stream
    r.note("reaped", bool(wait(lambda: (store.create("pods", MakePod(
        f"r{time.monotonic_ns()}").obj()) and False) or srv._mux.stream_count == 0, 10, 0.05)))


def scn_mux_bookmark_and_eviction(r: Run) -> None:
    import queue as _queue

    store = r.store()
    srv = r.server(store)
    MakePod = r.k("testing").MakePod
    WatchMux = r.k("server.watchmux").WatchMux
    old = WatchMux.BOOKMARK_EVERY
    WatchMux.BOOKMARK_EVERY = 0.2
    try:
        _, rv = store.list("pods")
        conn, resp = open_stream(srv, f"{PODS}?watch=true&resourceVersion={rv}")
        frames = read_frames(resp, lambda f: len(f) >= 1)
        r.note("bookmark", [frames[0]["type"],
                            "resourceVersion" in frames[0]["object"]["metadata"]])
        conn.close()
    finally:
        WatchMux.BOOKMARK_EVERY = old
    r.note("closed", bool(wait(lambda: (store.create("pods", MakePod(
        f"q{time.monotonic_ns()}").obj()) and False) or srv._mux.stream_count == 0, 10, 0.05)))
    # a watch evicted for falling behind ends its stream (the relist contract)
    _, rv = store.list("pods")
    conn, resp = open_stream(srv, f"{PODS}?watch=true&resourceVersion={rv}")
    try:
        wait(lambda: srv._mux.stream_count == 1, 5)
        with srv._mux._lock:
            st = srv._mux._streams[0]
        st.watch._q = _queue.Queue(maxsize=1)
        with store._lock:
            for i in range(3):
                store.create("pods", MakePod(f"burst{i}").obj())
        r.note("terminated", bool(wait(lambda: st.watch.terminated, 5)))
        frames = read_frames(resp, lambda f: False, timeout=5)
        r.note("eof", frames[-1]["type"] if frames else None)
        r.note("streams", bool(wait(lambda: srv._mux.stream_count == 0, 5)))
    finally:
        conn.close()
    # ?ring=true survives the same overflow, dropping its oldest deliveries
    _, rv = store.list("pods")
    conn, resp = open_stream(srv, f"{PODS}?watch=true&resourceVersion={rv}&ring=true")
    try:
        wait(lambda: srv._mux.stream_count == 1, 5)
        st = srv._mux._streams[0]
        r.note("ring", st.watch.ring)
        st.watch._q = _queue.Queue(maxsize=1)
        with store._lock:
            for i in range(4):
                store.create("pods", MakePod(f"ring{i}").obj())
        r.note("ring-terminated", st.watch.terminated)
        # how many of the four the writer drains before the burst is timing
        r.note("ring-dropped", st.watch.ring_dropped >= 2)
        frames = read_frames(resp, lambda f: f[-1]["object"]["metadata"]["name"] == "ring3",
                             skip_bookmarks=True, timeout=5)
        r.note("ring-last", frame_summary(frames)[-1:])
    finally:
        conn.close()


def scn_client_watch_and_informer(r: Run) -> None:
    store = r.store()
    srv = r.server(store)
    c = r.client(srv)
    MakePod = r.k("testing").MakePod
    _, rv = c.list("pods")
    got: List = []

    def consume():
        for etype, obj in c.watch("pods", since_rv=rv):
            got.append((etype, obj["metadata"]["name"]))
            if len(got) >= 3:
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    wait(lambda: srv._mux.stream_count == 1, 5)
    c.create("pods", {"metadata": {"name": "a"}, "spec": {"containers": [{"name": "c"}]}})
    c.delete("pods", "a")
    c.create("pods", {"metadata": {"name": "b"}, "spec": {"containers": [{"name": "c"}]}})
    t.join(timeout=10)
    r.note("client-watch", got)
    # the watch-list informer primes without a LIST, then resyncs after its
    # streams are severed with synthetic deltas only
    for i in range(3):
        store.create("pods", MakePod(f"p{i}").obj())
    events: List = []
    inf = r.k("server.client").Informer(c, "pods", on_event=lambda t_, o: events.append(
        (t_, o.metadata.name)), watch_list=True)
    inf.start()
    r.on_close(inf.stop)
    r.note("primed", bool(wait(lambda: len(inf.cache) == 4, 10)))
    with srv._mux._lock:
        for st in srv._mux._streams:
            st.sock.close()
    store.delete("pods", "default/p0")
    store.create("pods", MakePod("born").obj())
    r.note("converged", bool(wait(lambda: "default/born" in inf.cache
                                  and "default/p0" not in inf.cache, 15)))
    r.note("cache", sorted(inf.cache))
    r.note("events", sorted(set(events)))
    inf.stop()


# -- /metrics, /configz and /debug -----------------------------------------------


def metric_families(text: str) -> Dict[str, Any]:
    """/metrics by family: its TYPE and the label-key sets of its samples
    (values and latency sums/buckets are left out)."""
    fams: Dict[str, Any] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split(" ", 3)
            fams.setdefault(name, {"type": typ, "labels": set()})
        elif line and not line.startswith("#"):
            m = re.match(r"([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?", line)
            name = m.group(1)
            for suf in ("_bucket", "_sum", "_count"):
                if name.endswith(suf) and name[: -len(suf)] in fams:
                    name = name[: -len(suf)]
            keys = tuple(sorted(kv.split("=", 1)[0] for kv in
                                re.findall(r'[a-zA-Z_]+="[^"]*"', m.group(3) or "")
                                if kv.split("=", 1)[0] != "le"))
            fams.setdefault(name, {"type": None, "labels": set()})["labels"].add(keys)
    return {k: {"type": v["type"], "labels": sorted(v["labels"])} for k, v in fams.items()}


def scn_metrics_and_configz(r: Run) -> None:
    srv = r.server(flowcontrol="default")
    r.http(srv, "POST", PODS, pod("m"))
    st, text = r.http(srv, "GET", "/metrics", record=False)
    r.note("metrics-status", st)
    fams = metric_families(text)
    r.note("families", sorted(fams))
    r.note("apf", {k: v for k, v in fams.items() if k.startswith("apiserver_flowcontrol")})
    st, cfg = r.http(srv, "GET", "/configz", record=False)
    r.note("configz-status", st)
    r.note("configz-keys", sorted(cfg) if isinstance(cfg, dict) else cfg)


def _drive_scheduler(r: Run, store, n_nodes: int = 4, n_pods: int = 12):
    MakeNode, MakePod = r.k("testing").MakeNode, r.k("testing").MakePod
    for i in range(n_nodes):
        store.create("nodes", MakeNode(f"n{i}").capacity(
            {"cpu": "8", "memory": "16Gi", "pods": "110"}).obj())
    for i in range(n_pods):
        store.create("pods", MakePod(f"p{i}").req({"cpu": "500m"}).obj())
    kw = {"device": "cpu"} if r.k.is_port else {}
    fw = r.k("scheduler.runtime").Framework(r.k("scheduler.plugins").default_plugins())
    sched = r.k("scheduler.batch").BatchScheduler(store, fw, solver="fast", **kw)
    sched.sync()
    sched.run_until_idle()
    r.on_close(sched.stop)
    return sched


def _shape(x: Any) -> Any:
    """A /debug payload's structure: key sets and counts (list lengths,
    integer counters), with floats reduced to their type."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in sorted(x.items())}
    if isinstance(x, list):
        return ["list", len(x)] + ([_shape(x[0])] if x else [])
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return x if not isinstance(x, str) else "str"
    if isinstance(x, int):
        return "int"
    return type(x).__name__


def scn_debug_routes(r: Run) -> None:
    """The /debug family over a scheduler that ran: the routes keyed by
    live scheduler are read at this run's scheduler (the registry is
    process-wide: other schedulers of the process may still be alive);
    their payloads compared by key sets and counts. The trace ring is
    process-wide as well: a capture that an earlier test of the process
    armed and disarmed stays readable and fills the "tracebuf" section, so
    the run starts with none and puts the ring's state back after."""
    tb = r.k("obs.tracebuf")
    saved = (tb.ACTIVE, tb.LAST)
    tb.ACTIVE = tb.LAST = None

    def restore() -> None:
        tb.ACTIVE, tb.LAST = saved

    r.on_close(restore)
    store = r.store()
    sched = _drive_scheduler(r, store)
    srv = r.server(store)
    mine = sched._bind_origin
    for path in ("/debug/schedstats", "/debug/timeseries", "/debug/critpath",
                 "/debug/schedtrace"):
        st, body = r.http(srv, "GET", path, record=False)
        r.note(path, [st, isinstance(body, dict) and mine in body,
                      _shape(body.get(mine)) if isinstance(body, dict) else _shape(body)])
    for path in ("/debug/controlstats", "/debug/trace"):
        st, body = r.http(srv, "GET", path, record=False)
        r.note(path, [st, sorted(body) if isinstance(body, dict) else type(body).__name__])
    st, body = r.http(srv, "GET", "/debug/schedstats", record=False)
    only = body[mine]
    r.note("counts", {k: only.get(k) for k in ("solver", "batch_size", "batches_solved",
                                                "scheduled", "failed", "preemptions")})
    r.note("stages", sorted((only.get("stages") or {})))


SCENARIOS = {
    "crud": scn_crud,
    "selectors": scn_selectors,
    "patch_and_status": scn_patch_and_status,
    "discovery_and_health": scn_discovery_and_health,
    "crd": scn_crd,
    "exec_sessions": scn_exec_sessions,
    "client_calls": scn_events_and_bindings_over_client,
    "watch_since_rv": scn_watch_since_rv,
    "watch_list": scn_watch_list,
    "field_selector_watch": scn_field_selector_watch,
    "watch_mux": scn_watch_mux,
    "mux_bookmark_and_eviction": scn_mux_bookmark_and_eviction,
    "client_watch_and_informer": scn_client_watch_and_informer,
    "metrics_and_configz": scn_metrics_and_configz,
    "debug_routes": scn_debug_routes,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_server_parity(name):
    twin(SCENARIOS[name])

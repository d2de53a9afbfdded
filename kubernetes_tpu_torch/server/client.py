"""HTTP client for the API server — the client-go analog (typed REST + watch).

reference: staging/src/k8s.io/client-go/rest + tools/cache/reflector.go
(ListAndWatch with resourceVersion resume).

The counterpart of `kubernetes_tpu/server/client.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..api.serialize import GROUP_PREFIX, CLUSTER_SCOPED, from_dict


class APIError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code


class RESTClient:
    def __init__(self, base_url: str, timeout: float = 10.0,
                 token: Optional[str] = None, user: Optional[str] = None,
                 user_agent: str = ""):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        # token -> Authorization: Bearer (the secured path); user -> the
        # X-Remote-User convention honored by servers without an authenticator
        self.token = token
        self.user = user
        # first token doubles as the default field manager for writes
        # (the server's managedfields default chain reads User-Agent)
        self.user_agent = user_agent
        # plural/alias -> {"prefix", "namespaced"} for CRD-served resources,
        # filled lazily from GET /apis (the reference's discovery client)
        self._dynamic: Dict[str, Dict[str, Any]] = {}

    def _discover(self, resource: str) -> Dict[str, Any]:
        info = self._dynamic.get(resource)
        if info is not None:
            return info
        doc = self.request("GET", "/apis")
        self._dynamic = {}
        for plural, entry in (doc.get("resources") or {}).items():
            self._dynamic[plural] = entry
            for alias in entry.get("shortNames") or []:
                self._dynamic.setdefault(alias, entry)
            for alias in (entry.get("singular", ""),
                          entry.get("kind", "").lower()):
                if alias:
                    self._dynamic.setdefault(alias, entry)
        info = self._dynamic.get(resource)
        if info is None:
            raise APIError(404, f"unknown resource {resource!r} (discovery)")
        return info

    def _headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json"}
        if self.user_agent:
            h["User-Agent"] = self.user_agent
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        elif self.user:
            h["X-Remote-User"] = self.user
        return h

    def _path(self, resource: str, namespace: Optional[str], name: Optional[str] = None,
              subresource: Optional[str] = None) -> str:
        prefix = GROUP_PREFIX.get(resource)
        if prefix is not None:
            namespaced = resource not in CLUSTER_SCOPED
        else:
            info = self._discover(resource)
            prefix, namespaced = info["prefix"], bool(info.get("namespaced", True))
        if not namespaced or namespace is None:
            p = f"{prefix}/{resource}"
        else:
            p = f"{prefix}/namespaces/{namespace}/{resource}"
        if name:
            p += f"/{name}"
        if subresource:
            p += f"/{subresource}"
        return p

    def request_text(self, path: str) -> str:
        """GET a text/plain endpoint (the pods/{name}/log subresource)."""
        req = urllib.request.Request(self.base_url + path, method="GET",
                                     headers=self._headers())
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read().decode()
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
                msg = payload.get("message", str(e))
            except Exception:
                msg = str(e)
            raise APIError(e.code, msg) from None

    def logs(self, name: str, namespace: str = "default",
             tail_lines: int = 0) -> str:
        path = self._path("pods", namespace, name, "log")
        if tail_lines:
            path += f"?tailLines={tail_lines}"
        return self.request_text(path)

    def request(self, method: str, path: str, body: Optional[Dict] = None,
                timeout: Optional[float] = None,
                content_type: Optional[str] = None):
        data = json.dumps(body).encode() if body is not None else None
        headers = self._headers()
        if content_type:
            headers["Content-Type"] = content_type
        req = urllib.request.Request(self.base_url + path, data=data, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout or self.timeout) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
                msg = payload.get("message", str(e))
            except Exception:
                msg = str(e)
            raise APIError(e.code, msg) from None

    # -- typed operations ------------------------------------------------------

    def create(self, resource: str, obj_dict: Dict, namespace: Optional[str] = None):
        ns = namespace or (obj_dict.get("metadata") or {}).get("namespace") or "default"
        return self.request("POST", self._path(resource, ns), obj_dict)

    def get(self, resource: str, name: str, namespace: Optional[str] = "default") -> Dict:
        return self.request("GET", self._path(resource, namespace, name))

    def list(self, resource: str, namespace: Optional[str] = None,
             field_selector: str = "",
             label_selector: str = "") -> Tuple[List[Dict], int]:
        from urllib.parse import quote

        path = self._path(resource, namespace)
        params = []
        if field_selector:
            params.append(f"fieldSelector={quote(field_selector)}")
        if label_selector:
            params.append(f"labelSelector={quote(label_selector)}")
        if params:
            path += "?" + "&".join(params)
        out = self.request("GET", path)
        return out["items"], out["metadata"]["resourceVersion"]

    def update(self, resource: str, obj_dict: Dict, namespace: Optional[str] = None) -> Dict:
        meta = obj_dict.get("metadata") or {}
        ns = namespace or meta.get("namespace") or "default"
        return self.request("PUT", self._path(resource, ns, meta["name"]), obj_dict)

    def delete(self, resource: str, name: str, namespace: Optional[str] = "default") -> Dict:
        return self.request("DELETE", self._path(resource, namespace, name))

    def patch(self, resource: str, name: str, patch: Dict,
              namespace: Optional[str] = "default",
              patch_type: str = "application/strategic-merge-patch+json") -> Dict:
        """PATCH (merge semantics) — reference: handlers/patch.go."""
        return self.request("PATCH", self._path(resource, namespace, name),
                            patch, content_type=patch_type)

    def apply(self, resource: str, name: str, obj_dict: Dict,
              namespace: Optional[str] = "default",
              field_manager: str = "ktl", force: bool = False) -> Dict:
        """Server-side apply (handlers/patch.go:432): PATCH with the
        apply-patch content type; 409 Conflict lists owning managers unless
        force steals the fields."""
        from urllib.parse import quote

        path = (self._path(resource, namespace, name)
                + f"?fieldManager={quote(field_manager)}")
        if force:
            path += "&force=true"
        return self.request("PATCH", path, obj_dict,
                            content_type="application/apply-patch+yaml")

    def update_status(self, resource: str, obj_dict: Dict,
                      namespace: Optional[str] = None) -> Dict:
        """PUT the status subresource: only the status stanza lands (the
        kubelet/controller write path — spec is untouchable here)."""
        meta = obj_dict.get("metadata") or {}
        ns = namespace or meta.get("namespace") or "default"
        return self.request("PUT",
                            self._path(resource, ns, meta["name"], "status"),
                            obj_dict)

    def exec(self, name: str, command, namespace: str = "default",
             container: str = "", stdin: bytes = b"",
             timeout_seconds: float = 10.0) -> Dict:
        """Run a command in a pod's container (pods/{name}/exec session
        channel). Returns {stdout, stderr, exitCode}."""
        import base64

        body = {"command": list(command), "container": container,
                "timeoutSeconds": timeout_seconds}
        if stdin:
            body["stdin"] = base64.b64encode(stdin).decode()
        return self.request("POST", self._path("pods", namespace, name, "exec"),
                            body, timeout=timeout_seconds + 5)

    def attach(self, name: str, namespace: str = "default",
               container: str = "", stdin: bytes = b"",
               timeout_seconds: float = 10.0) -> Dict:
        """Attach to the running container: recent output + optional stdin."""
        import base64

        body = {"container": container, "timeoutSeconds": timeout_seconds}
        if stdin:
            body["stdin"] = base64.b64encode(stdin).decode()
        return self.request("POST",
                            self._path("pods", namespace, name, "attach"),
                            body, timeout=timeout_seconds + 5)

    def port_forward(self, name: str, port: int, data: bytes,
                     namespace: str = "default",
                     timeout_seconds: float = 10.0) -> bytes:
        """One port-forward connection round: bytes out, bytes back."""
        import base64

        out = self.request(
            "POST", self._path("pods", namespace, name, "portforward"),
            {"port": port, "data": base64.b64encode(data).decode(),
             "timeoutSeconds": timeout_seconds},
            timeout=timeout_seconds + 5)
        if out.get("error"):
            # backend failure must not masquerade as an empty response
            raise APIError(502, out["error"])
        return base64.b64decode(out.get("data", ""))

    def evict(self, name: str, namespace: str = "default") -> Dict:
        """PDB-respecting eviction (pods/{name}/eviction); 429 when a
        matching budget has no disruptions left."""
        return self.request("POST", self._path("pods", namespace, name, "eviction"),
                            {"kind": "Eviction",
                             "metadata": {"name": name, "namespace": namespace}})

    def bind(self, namespace: str, pod_name: str, node_name: str) -> Dict:
        return self.request("POST", self._path("pods", namespace, pod_name, "binding"),
                            {"target": {"kind": "Node", "name": node_name}})

    def watch(self, resource: str, since_rv: int = -1,
              namespace: Optional[str] = None,
              field_selector: str = "",
              label_selector: str = "",
              send_initial_events: bool = False,
              ring: bool = False) -> Iterator[Tuple[str, Dict]]:
        """Yields (event_type, object_dict); blocks on the streaming
        response. send_initial_events=True is the WatchList mode
        (KEP-3157): current objects stream first as ADDED, then a BOOKMARK
        annotated k8s.io/initial-events-end, then live events.

        ring=True subscribes through a lossy ring buffer (`?ring=true`,
       ): a slow consumer's overflow drops its own oldest
        delivery instead of terminating the subscription into a relist
        storm. OBSERVABILITY consumers (dashboards, `ktl ... -w`) must pass
        it; cache-building consumers (Informer) must not — they need the
        eviction/terminate contract to know they missed events."""
        from urllib.parse import quote

        path = self._path(resource, namespace) + f"?watch=true&resourceVersion={since_rv}"
        if send_initial_events:
            path += "&sendInitialEvents=true"
        if ring:
            path += "&ring=true"
        if field_selector:
            path += f"&fieldSelector={quote(field_selector)}"
        if label_selector:
            path += f"&labelSelector={quote(label_selector)}"
        req = urllib.request.Request(self.base_url + path, headers=self._headers())
        resp = urllib.request.urlopen(req, timeout=3600)
        for raw in resp:
            raw = raw.strip()
            if not raw:
                continue
            ev = json.loads(raw)
            yield ev["type"], ev["object"]


class Informer:
    """List+watch a resource into a local cache with handlers — the
    SharedIndexInformer analog over HTTP."""

    def __init__(self, client: RESTClient, resource: str,
                 on_event: Optional[Callable[[str, Any], None]] = None,
                 field_selector: str = "", label_selector: str = "",
                 watch_list: bool = False):
        self.client = client
        self.resource = resource
        self.cache: Dict[str, Any] = {}
        self.on_event = on_event
        # server-side scope (e.g. spec.nodeName=<me> for a kubelet informer)
        self.field_selector = field_selector
        self.label_selector = label_selector
        # WatchList mode (KEP-3157; reflector.go:121-143): NO separate LIST
        # — every (re)connect streams current objects as initial ADDED
        # events ending in an annotated bookmark, and the cache swap at the
        # bookmark replaces the relist path entirely
        self.watch_list = watch_list
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _swap_cache(self, fresh: Dict[str, Any]) -> None:
        """Replace the cache, emitting synthetic deltas for changes missed
        while disconnected (shared_informer replace semantics). Applied
        key-by-key — a clear()+update() would give concurrent readers an
        empty-cache window mid-resync. Survivors emit MODIFIED only when
        their resourceVersion moved (DeltaFIFO Replace dedup), so a
        transient blip doesn't replay a full-cluster reconcile storm."""
        old = dict(self.cache)
        gone = set(old) - set(fresh)
        for k in gone:
            self.cache.pop(k, None)
        self.cache.update(fresh)
        if self.on_event:
            for k in gone:
                self.on_event("DELETED", old[k])
            for k in set(fresh) - set(old):
                self.on_event("ADDED", fresh[k])
            for k in set(fresh) & set(old):
                if (old[k].metadata.resource_version
                        != fresh[k].metadata.resource_version):
                    self.on_event("MODIFIED", fresh[k])

    def _key(self, obj_dict: Dict) -> str:
        meta = obj_dict.get("metadata") or {}
        ns = meta.get("namespace")
        return f"{ns}/{meta['name']}" if ns else meta["name"]

    def start(self) -> "Informer":
        if self.watch_list:
            rv = -1  # the stream itself primes the cache
        else:
            items, rv = self.client.list(self.resource,
                                         field_selector=self.field_selector,
                                         label_selector=self.label_selector)
            for it in items:
                self.cache[self._key(it)] = from_dict(self.resource, it)

        def loop():
            nonlocal rv
            while not self._stop.is_set():
                try:
                    syncing = self.watch_list
                    fresh: Dict[str, Any] = {}
                    stream = self.client.watch(
                        self.resource,
                        since_rv=-1 if self.watch_list else rv,
                        field_selector=self.field_selector,
                        label_selector=self.label_selector,
                        send_initial_events=self.watch_list)
                    for etype, obj_dict in stream:
                        if self._stop.is_set():
                            return
                        if etype == "BOOKMARK":
                            # rv checkpoint only (reflector.go:156) — no object
                            meta = obj_dict.get("metadata") or {}
                            rv = int(meta.get("resourceVersion", rv))
                            if syncing and (meta.get("annotations") or {}).get(
                                    "k8s.io/initial-events-end") == "true":
                                self._swap_cache(fresh)
                                syncing = False
                            continue
                        obj = from_dict(self.resource, obj_dict)
                        key = self._key(obj_dict)
                        rv = int((obj_dict.get("metadata") or {}).get("resourceVersion", rv))
                        if syncing:
                            fresh[key] = obj  # initial burst: swap at the end bookmark
                            continue
                        if etype == "DELETED":
                            self.cache.pop(key, None)
                        else:
                            self.cache[key] = obj
                        if self.on_event:
                            self.on_event(etype, obj)
                except Exception:
                    if self._stop.is_set():
                        return
                    import time

                    time.sleep(0.2)
                    if self.watch_list:
                        continue  # reconnect re-syncs via initial events
                    # Reflector contract: RELIST then rewatch — retrying the
                    # stale rv after a 410 Expired would loop forever and
                    # freeze the cache.
                    try:
                        items, rv = self.client.list(
                            self.resource, field_selector=self.field_selector,
                            label_selector=self.label_selector)
                        # synthetic deltas for changes missed during the
                        # outage (shared_informer replace semantics)
                        self._swap_cache({self._key(it):
                                          from_dict(self.resource, it)
                                          for it in items})
                    except Exception:
                        pass  # server unreachable: retry the whole cycle

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

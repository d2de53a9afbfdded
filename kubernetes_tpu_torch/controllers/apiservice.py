"""APIService availability controller (kube-aggregator's
available_controller): probes each extension apiserver and flips the
Available condition the proxy gates on — an unreachable backend turns
requests into clean 503s instead of hanging proxies.

The counterpart of `kubernetes_tpu/controllers/apiservice.py`: the same
behaviour, names and store writes, held equal to it by the port's tests.
"""

from __future__ import annotations

import urllib.error
import urllib.request
from typing import Optional

from ..store import NotFoundError
from .base import Controller


class APIServiceAvailabilityController(Controller):
    watch_kinds = ("apiservices",)
    _RESYNC_EVERY = 100  # reconcile rounds between full re-probes (~5s idle)

    def key_of_object(self, kind: str, obj) -> Optional[str]:
        return obj.metadata.name

    def reconcile_once(self) -> int:
        n = super().reconcile_once()
        self._tick = getattr(self, "_tick", 0) + 1
        if self._tick >= self._RESYNC_EVERY:
            self._tick = 0
            svcs, _ = self.store.list("apiservices")
            for s in svcs:
                self._mark(s.metadata.name)
            n += self.process()
        return n

    def _probe(self, url: str) -> Optional[str]:
        """None = healthy; else the failure message."""
        try:
            with urllib.request.urlopen(url.rstrip("/") + "/healthz",
                                        timeout=3) as resp:
                if 200 <= resp.status < 300:
                    return None
                return f"healthz returned {resp.status}"
        except urllib.error.HTTPError as e:
            # a 404 healthz on a live server still proves reachability
            return None if e.code == 404 else f"healthz returned {e.code}"
        except (urllib.error.URLError, OSError) as e:
            return f"unreachable: {e}"

    def sync(self, key: str) -> None:
        try:
            svc = self.store.get("apiservices", key)
        except NotFoundError:
            return
        if svc.local:
            want, msg = True, "Local"
        else:
            failure = self._probe(svc.service_url)
            want, msg = failure is None, failure or ""
        if svc.available == want and svc.available_message == msg:
            return

        def flip(s):
            s.available = want
            s.available_message = msg
            return s

        self.store.guaranteed_update("apiservices", key, flip)

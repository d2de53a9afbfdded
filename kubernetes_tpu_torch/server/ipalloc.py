"""Service ClusterIP allocation — the apiserver registry's ipallocator.

reference: pkg/registry/core/service/ipallocator (bitmap allocator over the
service CIDR + the repair loop that rebuilds state from stored Services).
Services created without a clusterIP get the next free address; an explicit
request is honored or conflicts; "None" means headless (no allocation);
deletes release the address.

The counterpart of `kubernetes_tpu/server/ipalloc.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Optional, Set

HEADLESS = "None"


class ClusterIPAllocator:
    def __init__(self, store, cidr: str = "10.96.0.0/16"):
        self.network = ipaddress.ip_network(cidr)
        # skip the network and broadcast addresses like the reference
        self._base = int(self.network.network_address) + 1
        self._size = self.network.num_addresses - 2
        self._store = store
        self._lock = threading.Lock()
        self._used: Set[int] = set()
        self._cursor = 0
        # repair: rebuild from every stored Service (ipallocator/controller),
        # then track the store by WATCH — services die through many paths
        # (namespace sweep, GC, direct store deletes), not only REST DELETE,
        # and every one must release its address
        services, rv = store.list("services")
        for svc in services:
            self._mark(svc.spec.cluster_ip)
        self._watch = store.watch(kind="services", since_rv=rv)

    def _sync_locked(self) -> None:
        """Drain service events (caller holds the lock): deletes release,
        adds/updates mark — covering objects written around the REST layer."""
        if self._watch.terminated:
            # evicted slow watcher: full repair + rewatch (reflector contract)
            self._used.clear()
            services, rv = self._store.list("services")
            for svc in services:
                self._mark(svc.spec.cluster_ip)
            self._watch = self._store.watch(kind="services", since_rv=rv)
            return
        for ev in self._watch.drain():
            ip = ev.obj.spec.cluster_ip
            if ev.type == "DELETED":
                self._release_locked(ip)
            else:
                self._mark(ip)

    def _release_locked(self, ip: Optional[str]) -> None:
        if not ip or ip == HEADLESS:
            return
        try:
            off = int(ipaddress.ip_address(ip)) - self._base
        except ValueError:
            return
        self._used.discard(off)

    def _mark(self, ip: Optional[str]) -> None:
        if not ip or ip == HEADLESS:
            return
        try:
            n = int(ipaddress.ip_address(ip))
        except ValueError:
            return
        off = n - self._base
        if 0 <= off < self._size:
            self._used.add(off)

    def allocate(self, requested: str = "") -> str:
        """-> the assigned IP. Raises ValueError on exhaustion, an
        out-of-range request, or a conflict."""
        with self._lock:
            self._sync_locked()
            if requested:
                try:
                    n = int(ipaddress.ip_address(requested))
                except ValueError:
                    raise ValueError(f"invalid clusterIP {requested!r}")
                off = n - self._base
                if not (0 <= off < self._size):
                    raise ValueError(
                        f"clusterIP {requested} is not in range {self.network}")
                if off in self._used:
                    raise ValueError(f"clusterIP {requested} is already allocated")
                self._used.add(off)
                return requested
            if len(self._used) >= self._size:
                raise ValueError(f"service CIDR {self.network} exhausted")
            # next-free scan from a moving cursor (allocator's round-robin
            # bias keeps freshly released addresses quarantined briefly)
            for i in range(self._size):
                off = (self._cursor + i) % self._size
                if off not in self._used:
                    self._used.add(off)
                    self._cursor = (off + 1) % self._size
                    return str(ipaddress.ip_address(self._base + off))
            raise ValueError(f"service CIDR {self.network} exhausted")

    def release(self, ip: Optional[str]) -> None:
        with self._lock:
            self._sync_locked()
            self._release_locked(ip)

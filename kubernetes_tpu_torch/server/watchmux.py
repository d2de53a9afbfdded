"""Select-based watch fan-out: ONE writer thread for every watch stream.

The reference's WatchServer spends a goroutine per stream (handlers/
watch.go:187) — goroutines are cheap. Python threads are not: at 5k watch
streams on a small host, per-event thread wakeups + GIL churn collapsed
fan-out from 25k deliveries/s (500 watchers) to 2.2k/s (5000), with or
without burst batching. The mux replaces the per-stream handler loop: the
HTTP handler writes the response headers, detaches the connection (dup'd
fd), and registers (socket, Watch, render) here; one thread drains every
watch queue, renders frames (shared wire cache upstream), and writes with
a selector handling slow sockets via bounded per-stream backlogs.

Eviction keeps the store's slow-watcher contract: a stream whose pending
buffer exceeds MAX_PENDING (client not reading) or whose Watch was
terminated (queue overflow) is closed; the client relists, exactly as with
the threaded path.

The counterpart of `kubernetes_tpu/server/watchmux.py`: the same behaviour,
names and responses, held equal to it by the port's tests.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, List, Optional


def bookmark_frame(rv: int) -> bytes:
    """One chunk-framed BOOKMARK event — shared by the mux and the threaded
    watch path so the wire shape can never drift between them."""
    line = json.dumps(
        {"type": "BOOKMARK",
         "object": {"metadata": {"resourceVersion": str(rv)}}}
    ).encode() + b"\n"
    return f"{len(line):x}\r\n".encode() + line + b"\r\n"


class _Stream:
    __slots__ = ("sock", "watch", "render", "pending", "last_sent", "rv_fn")

    def __init__(self, sock, watch, render, rv_fn):
        self.sock = sock
        self.watch = watch
        self.render = render
        self.rv_fn = rv_fn
        self.pending = bytearray()
        self.last_sent = time.monotonic()


class WatchMux:
    MAX_PENDING = 4 * 1024 * 1024  # bytes buffered for a non-reading client
    BOOKMARK_EVERY = 5.0

    def __init__(self):
        self._streams: List[_Stream] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._stopped_forever = False
        self._thread: Optional[threading.Thread] = None

    # -- registration (called from handler threads) ----------------------------

    def add(self, sock: socket.socket, watch, render: Callable,
            rv_fn: Callable[[], int]) -> None:
        sock.setblocking(False)
        st = _Stream(sock, watch, render, rv_fn)
        # immediate wake on new events for THIS watch: the store's deliver
        # path pings the mux instead of waking a dedicated thread
        watch.on_event = self._wake.set
        with self._lock:
            if self._stopped_forever:
                # a handler racing server shutdown must not resurrect the
                # mux (a cleared _stop here would leak thread + stream)
                self._close(st, final_chunk=True)
                return
            self._streams.append(st)
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()
        self._wake.set()

    def stop(self) -> None:
        with self._lock:
            self._stopped_forever = True
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)
        with self._lock:
            streams, self._streams = self._streams, []
        for st in streams:
            self._close(st, final_chunk=True)

    @property
    def stream_count(self) -> int:
        with self._lock:
            return len(self._streams)

    # -- the loop --------------------------------------------------------------

    def _close(self, st: _Stream, final_chunk: bool = False) -> None:
        st.watch.stop()
        try:
            if final_chunk:
                st.sock.setblocking(False)
                st.sock.send(b"0\r\n\r\n")
        except OSError:
            pass
        try:
            st.sock.close()
        except OSError:
            pass

    def _flush(self, st: _Stream, now: float) -> bool:
        """Send buffered bytes; False = dead socket. Eviction for a
        non-reading client happens only when pending is STILL over the cap
        after the send attempt (a big burst to a fast reader drains here
        and must not be evicted)."""
        if st.pending:
            try:
                sent = st.sock.send(bytes(st.pending))
                if sent:
                    del st.pending[:sent]
                    st.last_sent = now
            except (BlockingIOError, InterruptedError):
                pass  # kernel buffer full: retry next pass
            except OSError:
                return False  # reset/broken pipe
        return len(st.pending) <= self.MAX_PENDING

    def _pump_stream(self, st: _Stream, now: float) -> bool:
        """Render new events into pending + flush; returns False when the
        stream is dead (terminated watch / over-buffered / peer gone)."""
        if st.watch.terminated:
            return False
        for ev in st.watch.drain(512):
            frame = st.render(ev)
            if frame is not None:
                st.pending += frame
        if not st.pending and now - st.last_sent >= self.BOOKMARK_EVERY:
            st.pending += bookmark_frame(st.rv_fn())
        if not self._flush(st, now):
            return False
        # peer-close detection: a readable watch socket either sent bytes
        # (clients don't) or closed
        try:
            got = st.sock.recv(4096)
            if got == b"":
                return False
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            return False
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            now = time.monotonic()
            with self._lock:
                streams = list(self._streams)
            dead = []
            for st in streams:
                try:
                    ok = self._pump_stream(st, now)
                except Exception:
                    # a poisoned render/predicate kills ONE stream, never
                    # the whole mux (the threaded path's blast radius)
                    ok = False
                if not ok:
                    dead.append(st)
            # drain partial writes promptly WITHOUT re-pumping healthy
            # streams: only sockets with buffered bytes are touched
            slow = [s for s in streams if s.pending and s not in dead]
            deadline = now + 0.2
            while slow and time.monotonic() < deadline \
                    and not self._stop.is_set():
                time.sleep(0.001)
                t = time.monotonic()
                still = []
                for st in slow:
                    try:
                        if not self._flush(st, t):
                            dead.append(st)
                        elif st.pending:
                            still.append(st)
                    except Exception:
                        dead.append(st)
                slow = still
            if slow:
                self._wake.set()  # backlog persists: next pass retries
            if dead:
                with self._lock:
                    self._streams = [s for s in self._streams
                                     if s not in dead]
                for st in dead:
                    self._close(st, final_chunk=True)

"""Session manager + stdlib HTTP server for interactive VOS serving
(counterpart of mivos_tpu/serve/server.py: the same API, status codes,
wire format and locking design).

Design (no reference analog -- the reference is a desktop GUI,
interactive_gui.py):

* One `SessionManager` owns all live sessions. Each session is pinned
  to a device round-robin at creation, and every call on it runs with
  that device current (`torch.cuda.device`), so concurrent requests for
  sessions on different cards run on different cards.
* The manager prepares one copy of the networks per device, once
  (`prepared_copies`): `InferenceCore` moves the nets
  it is given and casts bf16 weights in place, and two sessions must
  never do that to a net another handler thread is running. On a
  prepared copy those steps are no-ops.
* Per-session locks serialize interactions within a session (an
  InferenceCore mutates its bank); the registry lock is only held for
  bookkeeping, never across device work.
* Wire format: npz (zlib-compressed numpy archives). Label maps are
  piecewise constant, so savez_compressed ships them compactly without
  a custom decoder on the client.

HTTP API (`python -m mivos_tpu_torch.serve` binds it):
  POST   /v1/sessions?num_objects=K   body: npz{video (T,H,W,3) uint8}
                                      -> {"session_id": ...}
         ...&format=mp4[&min_side=480]  body: raw container bytes,
                                      decoded via interactive/video_io
                                      (any cv2-readable format)
  POST   /v1/sessions/<id>/interact   body: npz{labels (h,w) uint8,
                                      frame []}  -> npz{masks (T,h,w)}
  GET    /v1/sessions/<id>/masks      -> npz{masks} -- never blocks on
                                      an in-flight interact: busy
                                      sessions answer with the last
                                      COMPLETED round's masks
  GET    /v1/sessions/<id>/progress   -> npz{round, done, frames (n,),
                                      masks (n,h,w)} -- partial masks
                                      streamed per pass chunk WHILE an
                                      interact is still running
  DELETE /v1/sessions/<id>            -> {"closed": true}
  GET    /healthz                     -> {"ok": true, "sessions": N}
  GET    /metrics                     -> counters + interact latency
                                      percentiles (SessionManager.stats)

Status codes: 404 unknown/evicted session (typed SessionNotFound), 400
anything wrong inside a request body, 503 + Retry-After when the
manager is at max_sessions and no slot frees within the create timeout
(max_sessions is a HARD cap -- it bounds per-device memory).
"""
from __future__ import annotations

import io
import json
import math
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore, prepared_copies
from mivos_tpu_torch.parallel.mesh import device_scope
from mivos_tpu_torch.utils.tensor import labels_to_probs


def session_devices(devices=None) -> List[torch.device]:
    """`devices` (torch devices or names) for the entry points that run
    sessions on several devices; by default every CUDA device of the
    host. Raises when there is none: they never fall back to the CPU
    unless the caller names it."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=['cpu'] to run "
                           "on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class SessionNotFound(KeyError):
    """Unknown/evicted session id (HTTP 404)."""


class CapacityError(RuntimeError):
    """Manager at max_sessions and no room freed in time (HTTP 503)."""


class _Session:
    def __init__(self, core: InferenceCore, device: torch.device,
                 num_objects: int):
        self.core = core
        self.device = device
        self.k = num_objects
        self.lock = threading.Lock()
        self.last_used = time.monotonic()
        # Set (under self.lock) by eviction/shutdown; interact()/masks()
        # re-check it AFTER acquiring the lock so a request that
        # resolved the id just before eviction 404s instead of running
        # on a zombie session.
        self.closed = False
        # Progressive-streaming state (GET /progress): the passes stream
        # each chunk's labels here while interact() is still running.
        # Guarded by plock -- never by self.lock, which the in-flight
        # interact holds for its whole duration.
        self.plock = threading.Lock()
        self.prog_round = 0          # bumps at each interact() start
        self.prog_done = True        # no round in flight
        self.prog_have = np.zeros(core.t, bool)
        self.prog_masks = np.zeros_like(core.np_masks)
        # Last COMPLETED round's masks (plock-guarded): what GET /masks
        # serves while a round holds self.lock (prog_masks mid-round is
        # a mix of new chunks and the previous finals -- this stays a
        # consistent snapshot).
        self.last_masks = core.np_masks.copy()


class SessionManager:
    """Live InferenceCore sessions keyed by id, pinned round-robin to
    devices; oldest-idle sessions are evicted at max_sessions.

    devices: torch devices (or names) to serve on; by default every CUDA
    device, and without one the constructor raises (tests pass
    ["cpu"])."""

    def __init__(self, prop_net, fuse_net=None,
                 mem: MemoryConfig = MemoryConfig(), devices=None,
                 max_sessions: int = 8):
        self.devices = session_devices(devices)
        self.mem = mem
        # One prepared copy of the nets per device, made here, once (see
        # the module docstring): the caller's nets are left as they are.
        self._nets = prepared_copies((prop_net, fuse_net), self.devices)
        self.max_sessions = max_sessions
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()
        # Signalled whenever room may have opened (a close, an eviction,
        # or an in-flight creation resolving) -- create() waits on it.
        self._room = threading.Condition(self._lock)
        self._next_dev = 0
        # Observability counters (GET /metrics): lifetime totals + a
        # rolling window of interaction latencies for the percentiles.
        self._created = 0
        self._interactions = 0
        self._evicted = 0
        self._pending = 0  # creations in flight (reserve their slots)
        self._draining = False  # shutdown(): refuse new work
        self._latencies: list = []  # rolling, capped at 512

    def prepared_nets(self, device) -> Tuple:
        """(prop_net, fuse_net) as the sessions on `device` run them."""
        return self._nets[torch.device(device)]

    def warm(self, t: int, h: int, w: int, num_objects: int,
             interactions: int = 1) -> float:
        """Run a throwaway session (zeros video, `interactions` rounds on
        distinct frames) at (t, h, w, K) on one device (the next in the
        round robin), so that the first user there skips the one-time
        costs: the kernel library's build and load
        (`ops/cuda/build.py::load_library`), CUDA's lazy module loading
        and cuDNN's plans for these shapes. Returns the seconds spent
        (the cold-start cost the first user would have paid)."""
        t0 = time.monotonic()
        video = np.zeros((t, h, w, 3), np.uint8)
        labels = np.zeros((h, w), np.uint8)
        for k in range(num_objects):  # a sliver of every object id
            labels[:, k::num_objects] = k + 1
        sid = self.create(video, num_objects)
        try:
            # Spread rounds over distinct frames: pass lengths differ
            # per interaction frame, as in a real multi-round session.
            for i in range(max(1, interactions)):
                self.interact(sid, labels, (i * max(1, t // 3)) % t)
        finally:
            self.close(sid)
        return time.monotonic() - t0

    def create(self, video: np.ndarray, num_objects: int,
               timeout: float = 120.0) -> str:
        """video: (T, H, W, 3) uint8 (raw frames; normalized on device)
        or float32 (pre-normalized). Returns the session id.

        max_sessions is a HARD cap (it bounds per-device memory:
        device-resident video + bank per session). The slot is reserved
        BEFORE the slow session build; when eviction cannot make room
        (every session busy or slots held by in-flight creations), this
        waits up to `timeout` seconds for a close/eviction/creation to
        free one, then raises CapacityError (HTTP 503)."""
        if video.ndim != 4 or video.shape[-1] != 3:
            raise ValueError(f"video must be (T, H, W, 3), got "
                             f"{video.shape}")
        deadline = time.monotonic() + timeout
        with self._room:
            self._pending += 1
            try:
                while True:
                    if self._draining:
                        raise CapacityError("server draining")
                    self._evict_locked(keep_room=self._pending)
                    if (len(self._sessions) + self._pending
                            <= self.max_sessions):
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise CapacityError(
                            f"at capacity ({self.max_sessions} sessions)")
                    self._room.wait(left)
            except BaseException:
                self._pending -= 1
                self._room.notify_all()
                raise
            dev = self.devices[self._next_dev % len(self.devices)]
            self._next_dev += 1
        try:
            prop, fuse = self._nets[dev]
            with device_scope(dev), torch.no_grad():
                core = InferenceCore(prop, fuse, video, num_objects,
                                     mem=self.mem, device=dev)
            sid = uuid.uuid4().hex[:16]
            with self._lock:
                self._sessions[sid] = _Session(core, dev, num_objects)
                self._created += 1
        finally:
            with self._room:
                self._pending -= 1
                self._room.notify_all()
        return sid

    def interact(self, sid: str, labels: np.ndarray,
                 frame_idx: int) -> np.ndarray:
        """labels: (h, w) uint8 map (0 = background, 1..K = objects) for
        frame_idx. Propagates and returns all (T, h, w) labels."""
        if self._draining:
            raise CapacityError("server draining")
        s = self._get(sid)
        # Touch last_used BEFORE the (possibly long) interaction so an
        # active session is not the LRU eviction victim mid-flight.
        s.last_used = t0 = time.monotonic()
        with s.lock, device_scope(s.device):
            if s.closed:  # evicted between _get and the lock acquire
                raise SessionNotFound(sid)
            with s.plock:  # new round: reset the progress stream
                s.prog_round += 1
                s.prog_done = False
                s.prog_have[:] = False

            def _chunk(tis, labs):
                with s.plock:
                    s.prog_masks[tis] = labs
                    s.prog_have[tis] = True

            mask = labels_to_probs(np.asarray(labels), s.k)
            try:
                out = s.core.interact(mask, int(frame_idx),
                                      chunk_cb=_chunk).copy()
            finally:
                with s.plock:  # final masks are authoritative
                    s.prog_masks[:] = s.core.np_masks
                    s.prog_have[:] = True
                    s.prog_done = True
                    s.last_masks = s.core.np_masks.copy()
        s.last_used = time.monotonic()
        with self._room:
            self._interactions += 1
            self._latencies.append(s.last_used - t0)
            del self._latencies[:-512]
            # The session is idle again, i.e. evictable -- wake any
            # create() blocked on capacity.
            self._room.notify_all()
        return out

    def masks(self, sid: str) -> np.ndarray:
        s = self._get(sid)
        # NON-blocking on the session lock: an in-flight interact holds
        # it for the whole pass, and a client polling /masks must not
        # pin a handler thread for that duration. Busy -> serve the
        # last-completed round's snapshot (GET /progress is the endpoint
        # for the in-flight round's partial chunks).
        if s.lock.acquire(blocking=False):
            try:
                if s.closed:
                    raise SessionNotFound(sid)
                s.last_used = time.monotonic()
                # Copy under the lock: np_masks is the session's live
                # buffer, mutated in place by the next interact.
                return s.core.np_masks.copy()
            finally:
                s.lock.release()
        with s.plock:
            return s.last_masks.copy()

    def progress(self, sid: str) -> Dict:
        """Partial results of the round in flight (or the last finished
        one): {"round", "done", "frames" (n,) int32, "masks" (n, h, w)
        uint8}. Reads ONLY the plock-guarded stream buffer the passes
        publish into, so it answers at once while an interact still runs
        -- the progressive-mask analog of the reference GUI's per-frame
        progress callbacks (interactive_gui.py:530-540)."""
        s = self._get(sid)
        with s.plock:
            tis = np.nonzero(s.prog_have)[0].astype(np.int32)
            return {"round": s.prog_round, "done": s.prog_done,
                    "frames": tis, "masks": s.prog_masks[tis].copy()}

    def close(self, sid: str) -> bool:
        with self._room:
            s = self._sessions.pop(sid, None)
            if s is not None:
                # An interact already past its closed-check finishes and
                # returns (the client asked for the close; its in-flight
                # result is still delivered) -- later calls 404.
                s.closed = True
                self._room.notify_all()
            return s is not None

    def shutdown(self, timeout: float = 30.0) -> bool:
        """Drain-style shutdown: stop accepting creates/interacts
        (CapacityError -> HTTP 503), wait up to `timeout` for in-flight
        interactions to finish, then free every session. Returns True
        if fully drained (False: some interaction was still running at
        the deadline; its session is closed out from under it)."""
        deadline = time.monotonic() + timeout
        with self._room:
            self._draining = True
            self._room.notify_all()  # fail parked create()s fast
        drained = True
        for s in list(self._sessions.values()):
            # Acquiring the session lock = its in-flight work is done.
            if s.lock.acquire(timeout=max(0.0, deadline
                                          - time.monotonic())):
                s.closed = True
                s.lock.release()
            else:
                s.closed = True
                drained = False
        with self._room:
            self._sessions.clear()
            self._room.notify_all()
        return drained

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _get(self, sid: str) -> _Session:
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                raise SessionNotFound(sid)
            return s

    def _evict_locked(self, keep_room: int) -> None:
        """Evict oldest-idle sessions until keep_room slots are free.
        Caller holds self._room. Eviction HOLDS the victim's session
        lock while marking it closed: an interact() that resolved the
        id just before either beats us to the lock (then the acquire
        below fails -- not evictable) or acquires after us and sees
        s.closed -> SessionNotFound, never a silent run on a zombie.
        If nothing is idle the caller waits on _room (no overshoot)."""
        woke = False
        while len(self._sessions) > self.max_sessions - keep_room:
            evicted = None
            for k in sorted(self._sessions,
                            key=lambda k: self._sessions[k].last_used):
                s = self._sessions[k]
                if s.lock.acquire(blocking=False):
                    try:
                        s.closed = True
                    finally:
                        s.lock.release()
                    evicted = k
                    break
            if evicted is None:
                break  # everyone mid-interaction; create() waits
            del self._sessions[evicted]
            self._evicted += 1
            woke = True
        if woke:
            # Room opened: wake other create()s parked in wait().
            self._room.notify_all()

    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._latencies)

            def pct(p: float) -> Optional[float]:
                # Nearest-rank percentile: ceil(p*n) - 1.
                if not lat:
                    return None
                return round(lat[max(0, math.ceil(p * len(lat)) - 1)], 3)

            return {"sessions": len(self._sessions),
                    "created": self._created,
                    "interactions": self._interactions,
                    "evicted": self._evicted,
                    "devices": len(self.devices),
                    "interact_p50_s": pct(0.50),
                    "interact_p95_s": pct(0.95)}


def _npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _unnpz(data: bytes) -> Dict[str, np.ndarray]:
    # allow_pickle stays off: the body comes from the network.
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


class VOSRequestHandler(BaseHTTPRequestHandler):
    """Routes the HTTP API onto a SessionManager (set as the server's
    `manager` attribute by make_server)."""

    _SESSION = re.compile(
        r"^/v1/sessions/([0-9a-f]+)/?(masks|interact|progress)?$")

    # --- helpers -----------------------------------------------------
    def _json(self, code: int, obj, headers: Dict = None) -> None:
        body = json.dumps(obj).encode()
        self._raw(code, body, "application/json", headers)

    def _raw(self, code: int, body: bytes,
             ctype: str = "application/octet-stream",
             headers: Dict = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n)

    def log_message(self, fmt, *a):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *a)

    @property
    def manager(self) -> SessionManager:
        return self.server.manager  # type: ignore[attr-defined]

    # --- routes ------------------------------------------------------
    def do_GET(self):
        if self.path == "/healthz":
            return self._json(200, {"ok": True,
                                    "sessions": len(self.manager)})
        if self.path == "/metrics":
            return self._json(200, self.manager.stats())
        m = self._SESSION.match(self.path)
        if m and m.group(2) == "masks":
            try:
                masks = self.manager.masks(m.group(1))
            except SessionNotFound:
                return self._json(404, {"error": "no such session"})
            return self._raw(200, _npz({"masks": masks}))
        if m and m.group(2) == "progress":
            # Progressive streaming: poll while an interact runs; the
            # passes publish each chunk's masks as it completes.
            try:
                p = self.manager.progress(m.group(1))
            except SessionNotFound:
                return self._json(404, {"error": "no such session"})
            return self._raw(200, _npz(
                {"round": np.int32(p["round"]),
                 "done": np.uint8(p["done"]),
                 "frames": p["frames"], "masks": p["masks"]}))
        self._json(404, {"error": "unknown route"})

    def do_POST(self):
        if self.path.startswith("/v1/sessions?") or \
                self.path == "/v1/sessions":
            return self._guard400(self._create_session)
        m = self._SESSION.match(self.path)
        if m and m.group(2) == "interact":
            sid = m.group(1)
            try:
                self.manager._get(sid)  # 404 before parsing the body
            except SessionNotFound:
                return self._json(404, {"error": "no such session"})
            return self._guard400(lambda: self._interact(sid))
        self._json(404, {"error": "unknown route"})

    def _guard400(self, fn) -> None:
        """Map manager exceptions to status codes. SessionNotFound (the
        id vanished, e.g. evicted between route check and run) -> 404;
        CapacityError -> 503 + Retry-After; anything else raised inside
        a request body is the CLIENT's error (bad npz keys, shape
        mismatches, out-of-range frames, undecodable video...) -- answer
        400 with the message rather than letting the exception kill the
        handler thread with no response."""
        try:
            fn()
        except SessionNotFound:
            self._json(404, {"error": "no such session"})
        except CapacityError as e:
            self._json(503, {"error": str(e)}, headers={"Retry-After": "5"})
        except Exception as e:  # noqa: BLE001 -- see docstring
            self._json(400, {"error": f"{type(e).__name__}: {e}"})

    def _create_session(self) -> None:
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        k = int(q.get("num_objects", ["1"])[0])
        fmt = q.get("format", ["npz"])[0]
        if fmt == "npz":
            video = _unnpz(self._body())["video"]
        else:  # raw container bytes (mp4/avi/...): cv2 decode
            import tempfile

            from mivos_tpu_torch.interactive.video_io import load_video

            min_side = int(q.get("min_side", ["480"])[0])
            with tempfile.NamedTemporaryFile(suffix=f".{fmt}") as tmp:
                tmp.write(self._body())
                tmp.flush()
                video = load_video(tmp.name, min_side=min_side)
        # A short timeout here, unlike create()'s default: a queued
        # HTTP create pins a handler thread, so at capacity we 503
        # (+Retry-After) quickly rather than pile up threads.
        sid = self.manager.create(
            video, k, timeout=getattr(self.server, "create_timeout", 5.0))
        self._json(200, {"session_id": sid})

    def _interact(self, sid: str) -> None:
        data = _unnpz(self._body())
        # SessionNotFound (evicted between route check and run) -> 404
        # and a missing npz key (plain KeyError) -> 400, both via
        # _guard400's typed mapping.
        masks = self.manager.interact(sid, data["labels"],
                                      int(data["frame"]))
        self._raw(200, _npz({"masks": masks}))

    def do_DELETE(self):
        m = self._SESSION.match(self.path)
        if m and not m.group(2):
            return self._json(200, {"closed":
                                    self.manager.close(m.group(1))})
        self._json(404, {"error": "unknown route"})


def make_server(manager: SessionManager, host: str = "127.0.0.1",
                port: int = 0, verbose: bool = False,
                create_timeout: float = 5.0) -> ThreadingHTTPServer:
    """Bind (but do not start) the HTTP server; port 0 picks a free
    port (server.server_address reports it). Call serve_forever() or
    run it in a thread. create_timeout: how long an HTTP create waits
    at capacity before 503 (short -- each one pins a handler thread).

    Graceful stop: shutdown_gracefully(srv) (or srv.shutdown() then
    manager.shutdown() by hand)."""
    srv = ThreadingHTTPServer((host, port), VOSRequestHandler)
    srv.manager = manager  # type: ignore[attr-defined]
    srv.verbose = verbose  # type: ignore[attr-defined]
    srv.create_timeout = create_timeout  # type: ignore[attr-defined]
    return srv


def shutdown_gracefully(srv: ThreadingHTTPServer,
                        timeout: float = 30.0) -> bool:
    """Drain-style stop: stop the accept loop (no new connections; the
    in-flight handler threads keep running), drain the manager
    (in-flight interactions finish, queued work 503s, sessions freed),
    then close the socket. Returns the manager's drained flag."""
    srv.shutdown()  # stops serve_forever; running handlers continue
    drained = srv.manager.shutdown(timeout)  # type: ignore[attr-defined]
    srv.server_close()
    return drained

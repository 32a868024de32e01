"""The serving transport: a binary RPC over persistent connections, and
routing between models (counterpart of `embeddingtables_tpu/rpc.py`, whose
wire format it speaks byte for byte, so a client of either package talks to
a server of the other).

  - Framing: length-prefixed binary frames that carry raw numpy buffers
    (a dtype and shape header, then the bytes) over one long-lived TCP
    connection. Requests carry a client-chosen `req_id`; responses may come
    back out of order (each when its micro-batch flushes), so one
    connection pipelines many requests in flight.
  - Routing: a `ModelRouter` maps model names to the port's
    `serving.MicroBatcher`s, so one endpoint serves several models or
    versions ("dlrm", "dlrm_int8", "retrieval") and swaps them
    (`register` / `unregister`) without dropping the listener.
  - `RPCServer` / `RPCClient`: a stdlib-socket server (a thread per
    connection, one writer lock per connection) and a pipelining client
    (`submit()` returns a Future; a reader thread matches the req_ids).

Wire format (little-endian):

  frame    := u32 length, payload[length]
  request  := u32 req_id, u8 op, u8 name_len, name bytes, u8 narr, arr*
  op       := 0 predict | 1 stats | 2 list_models | 3 ping
  arr      := u8 dtype_code, u8 ndim, u32 dim*, raw bytes (C order)
  response := u32 req_id, u8 status, body
  status   := 0 ok (body = u8 narr, arr*) | 1 error (body = utf-8 message)

A predict is `MicroBatcher.submit(dense, cat)`: the arrays are (dense, cat)
on the way in and the result tuple (scores[, ids]) on the way out.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from concurrent.futures import Future
from typing import Callable, Dict, Optional

import numpy as np

from .serving import MicroBatcher

MAX_FRAME = 256 * 1024 * 1024

OP_PREDICT, OP_STATS, OP_LIST, OP_PING = 0, 1, 2, 3

_DTYPES = [np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.int64),
           np.dtype(np.float16), np.dtype(np.uint8), np.dtype(np.float64)]
_DTYPE_CODE = {dt: i for i, dt in enumerate(_DTYPES)}


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def _pack_array(a: np.ndarray) -> bytes:
    a = np.ascontiguousarray(a)
    code = _DTYPE_CODE.get(a.dtype)
    if code is None:
        raise TypeError(f"unsupported dtype {a.dtype}")
    head = struct.pack("<BB", code, a.ndim) + struct.pack(
        f"<{a.ndim}I", *a.shape)
    return head + a.tobytes()


def _unpack_array(buf: memoryview, off: int):
    code, ndim = struct.unpack_from("<BB", buf, off)
    off += 2
    shape = struct.unpack_from(f"<{ndim}I", buf, off)
    off += 4 * ndim
    dt = _DTYPES[code]
    n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    a = np.frombuffer(buf[off:off + n], dtype=dt).reshape(shape)
    return a, off + n


def pack_request(req_id: int, op: int, model: str, arrays=()) -> bytes:
    name = model.encode()
    if len(name) > 255:
        raise ValueError("model name too long")
    body = struct.pack("<IBB", req_id, op, len(name)) + name
    body += struct.pack("<B", len(arrays))
    for a in arrays:
        body += _pack_array(np.asarray(a))
    return struct.pack("<I", len(body)) + body


def pack_response(req_id: int, arrays=None, error: str | None = None) -> bytes:
    if error is not None:
        body = struct.pack("<IB", req_id, 1) + error.encode()
    else:
        body = struct.pack("<IB", req_id, 0)
        body += struct.pack("<B", len(arrays))
        for a in arrays:
            body += _pack_array(np.asarray(a))
    return struct.pack("<I", len(body)) + body


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        got = sock.recv(min(n, 1 << 20))
        if not got:
            return None
        chunks.append(got)
        n -= len(got)
    return b"".join(chunks)


def read_frame(sock: socket.socket) -> Optional[memoryview]:
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack("<I", head)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds MAX_FRAME")
    body = _recv_exact(sock, length)
    return None if body is None else memoryview(body)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

class ModelRouter:
    """Name -> MicroBatcher registry with hot-swap semantics."""

    def __init__(self):
        self._models: Dict[str, MicroBatcher] = {}
        self._lock = threading.Lock()

    def register(self, name: str, batcher: MicroBatcher,
                 *, stop_previous: bool = True):
        with self._lock:
            old = self._models.get(name)
            self._models[name] = batcher
        if old is not None and stop_previous:
            old.stop()

    def unregister(self, name: str, *, stop: bool = True):
        with self._lock:
            b = self._models.pop(name, None)
        if b is not None and stop:
            b.stop()

    def get(self, name: str) -> MicroBatcher:
        with self._lock:
            b = self._models.get(name)
        if b is None:
            raise KeyError(f"unknown model {name!r}; have "
                           f"{sorted(self._models)}")
        return b

    def names(self):
        with self._lock:
            return sorted(self._models)

    def stop_all(self):
        with self._lock:
            models, self._models = dict(self._models), {}
        for b in models.values():
            b.stop()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class RPCServer:
    """Persistent-connection RPC front end over a ModelRouter.

    One OS thread per connection reads frames; predict requests go straight
    into the routed model's MicroBatcher (where cross-connection batching
    happens) and each response is written when its Future resolves —
    out-of-order, under a per-connection writer lock.
    """

    def __init__(self, router: ModelRouter, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.5)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._acceptor = threading.Thread(target=self._accept_loop,
                                          daemon=True, name="rpc-accept")
        self._acceptor.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="rpc-conn").start()

    def _serve_conn(self, conn: socket.socket):
        wlock = threading.Lock()

        def send(data: bytes):
            with wlock:
                try:
                    conn.sendall(data)
                except OSError:
                    pass

        try:
            while not self._stop.is_set():
                try:
                    frame = read_frame(conn)
                except (OSError, ValueError):
                    break
                if frame is None:
                    break
                self._handle(frame, send)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_lock:
                self._conns.discard(conn)

    def _handle(self, frame: memoryview, send: Callable[[bytes], None]):
        req_id, op, nlen = struct.unpack_from("<IBB", frame, 0)
        off = 6
        model = bytes(frame[off:off + nlen]).decode()
        off += nlen
        try:
            if op == OP_PING:
                send(pack_response(req_id, arrays=()))
                return
            if op == OP_LIST:
                names = np.frombuffer(
                    json.dumps(self.router.names()).encode(), np.uint8)
                send(pack_response(req_id, arrays=(names,)))
                return
            if op == OP_STATS:
                snap = self.router.get(model).stats_snapshot()
                # Legacy wire aliases (earlier payloads used these names).
                snap["padded"] = snap["padded_examples"]
                snap["buckets"] = snap["bucket_sizes"]
                blob = json.dumps(snap).encode()
                send(pack_response(req_id,
                                   arrays=(np.frombuffer(blob, np.uint8),)))
                return
            if op != OP_PREDICT:
                raise ValueError(f"unknown op {op}")
            (narr,) = struct.unpack_from("<B", frame, off)
            off += 1
            arrays = []
            for _ in range(narr):
                a, off = _unpack_array(frame, off)
                arrays.append(a)
            if len(arrays) != 2:
                raise ValueError(f"predict expects (dense, cat), "
                                 f"got {len(arrays)} arrays")
            fut = self.router.get(model).submit(arrays[0], arrays[1])
        except Exception as e:  # noqa: BLE001 — surface to the client
            send(pack_response(req_id, error=f"{type(e).__name__}: {e}"))
            return

        def done(f: Future, req_id=req_id):
            try:
                out = f.result()
                outs = out if isinstance(out, tuple) else (out,)
                send(pack_response(req_id, arrays=outs))
            except Exception as e:  # noqa: BLE001
                send(pack_response(req_id, error=f"{type(e).__name__}: {e}"))

        fut.add_done_callback(done)

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            # shutdown first: close() alone neither wakes this server's
            # reader blocked on the socket nor sends the client its EOF
            # until that read returns.
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._acceptor.join(timeout=5)


def serve_rpc(models: Dict[str, MicroBatcher] | ModelRouter,
              host: str = "127.0.0.1", port: int = 0) -> RPCServer:
    """Start an RPCServer over the given models (dict or prebuilt router)."""
    router = models if isinstance(models, ModelRouter) else ModelRouter()
    if not isinstance(models, ModelRouter):
        for name, b in models.items():
            router.register(name, b)
    return RPCServer(router, host, port)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class RPCClient:
    """Pipelining client: `submit()` returns a Future immediately; a reader
    thread matches out-of-order responses by req_id. Thread-safe."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._plock = threading.Lock()
        self._next_id = 0
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="rpc-client-reader")
        self._reader.start()

    def _read_loop(self):
        try:
            while not self._closed.is_set():
                frame = read_frame(self._sock)
                if frame is None:
                    break
                req_id, status = struct.unpack_from("<IB", frame, 0)
                with self._plock:
                    fut = self._pending.pop(req_id, None)
                if fut is None:
                    continue
                if status != 0:
                    fut.set_exception(
                        RuntimeError(bytes(frame[5:]).decode()))
                    continue
                (narr,) = struct.unpack_from("<B", frame, 5)
                off, arrays = 6, []
                for _ in range(narr):
                    # Copy out of the frame so buffers outlive it.
                    a, off = _unpack_array(frame, off)
                    arrays.append(np.array(a))
                fut.set_result(tuple(arrays) if narr != 1 else arrays[0])
        except OSError:
            pass
        finally:
            err = ConnectionError("RPC connection closed")
            with self._plock:
                pending, self._pending = dict(self._pending), {}
            for fut in pending.values():
                if not fut.done():
                    fut.set_exception(err)

    def _send(self, op: int, model: str, arrays=()) -> Future:
        if self._closed.is_set():
            raise RuntimeError("client closed")
        if not self._reader.is_alive():
            # Nobody is left to resolve futures: fail fast instead of
            # buffering into a half-dead socket and hanging the caller.
            raise ConnectionError("RPC connection closed")
        fut: Future = Future()
        with self._plock:
            req_id = self._next_id
            self._next_id = (self._next_id + 1) & 0xFFFFFFFF
            self._pending[req_id] = fut
        data = pack_request(req_id, op, model, arrays)
        try:
            with self._wlock:
                self._sock.sendall(data)
        except OSError as e:
            with self._plock:
                self._pending.pop(req_id, None)
            raise ConnectionError(f"RPC send failed: {e}") from e
        if not self._reader.is_alive():
            # Raced with reader death: its final flush may have run before
            # our registration, leaving this future unresolvable. (If the
            # flush DID cover it, pop returns None and the flush already
            # failed it.)
            with self._plock:
                popped = self._pending.pop(req_id, None)
            if popped is not None and not fut.done():
                fut.set_exception(ConnectionError("RPC connection closed"))
        return fut

    def submit(self, model: str, dense, cat) -> Future:
        return self._send(OP_PREDICT, model,
                          (np.asarray(dense, np.float32),
                           np.asarray(cat, np.int32)))

    def predict(self, model: str, dense, cat, timeout: float = 30.0):
        return self.submit(model, dense, cat).result(timeout)

    def stats(self, model: str, timeout: float = 10.0) -> dict:
        blob = self._send(OP_STATS, model).result(timeout)
        return json.loads(np.asarray(blob).tobytes().decode())

    def list_models(self, timeout: float = 10.0) -> list:
        blob = self._send(OP_LIST, "").result(timeout)
        return json.loads(np.asarray(blob).tobytes().decode())

    def ping(self, timeout: float = 10.0) -> bool:
        self._send(OP_PING, "").result(timeout)
        return True

    def close(self):
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._reader.join(timeout=5)

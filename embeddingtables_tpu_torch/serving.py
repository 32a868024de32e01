"""Serving layer: request micro-batching over the DLRM forward (counterpart
of `embeddingtables_tpu/serving.py`).

  - `MicroBatcher`: a thread-safe coalescer. Callers `submit()` one request
    (any small batch) and get a `concurrent.futures.Future`; a worker thread
    concatenates queued requests and flushes when `max_batch` fills or
    `max_latency_ms` elapses since the oldest queued request. Flushed
    batches are padded up to power-of-two buckets, so the device sees
    O(log max_batch) distinct batch shapes.
  - `make_dlrm_service`, `make_dcn_service`, `make_deepfm_service`: glue
    from a CTR model, or its int8 / int4 quantized tables (`quant.py`), to a
    `MicroBatcher`; `make_retrieval_service` serves a two-tower model's
    top-k retrieval the same way. With `mesh=` each serves a sharded model
    (the CTR families; the DLRM and DCN also a planned one) or a sharded
    index (retrieval) from every rank of the mesh: rank 0 batches and
    broadcasts, the other ranks follow (`MeshFollower`).
  - `make_refreshable_service` (any CTR family) and
    `make_refreshable_dlrm_service`: a service whose tables (or whole model)
    can be swapped while it serves, for a replica that follows a trainer's
    delta checkpoints through `utils.DeltaFollower`.
  - `serve_http`: a stdlib `ThreadingHTTPServer` JSON endpoint
    (`POST /predict`) over a `MicroBatcher`.

Shapes: dense `(b, num_dense)` float32, cat `(T, b[, bag])` int32
(table-major); scores `(b,)`.
"""
from __future__ import annotations

import contextlib
import copy
import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from . import quant
from .models import dcn, deepfm, dlrm, two_tower
from .ops.ensemble import StackedTables


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, clamped to max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


@dataclass
class _Pending:
    dense: np.ndarray
    cat: np.ndarray
    future: Future
    size: int


@dataclass
class BatcherStats:
    requests: int = 0
    examples: int = 0
    batches: int = 0
    padded_examples: int = 0           # wasted compute from bucket padding
    bucket_sizes: set = field(default_factory=set)


class MicroBatcher:
    """Coalesce concurrent single requests into padded device batches.

    predict_fn: `(dense (B, d), cat (T, B[, bag])) -> scores (B,)`; called
    from ONE worker thread (one stream of device work), with B drawn from
    power-of-two bucket sizes only.
    """

    def __init__(self, predict_fn: Callable, *, max_batch: int = 1024,
                 max_latency_ms: float = 5.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._predict = predict_fn
        self.max_batch = max_batch
        self.max_latency = max_latency_ms / 1e3
        self.stats = BatcherStats()
        self._stats_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self._carry: Optional[_Pending] = None
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    # -- client side --------------------------------------------------------
    def submit(self, dense, cat) -> Future:
        """Queue one request; resolves to its `(b,)` float32 scores."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is stopped")
        dense = np.asarray(dense, np.float32)
        cat = np.asarray(cat, np.int32)
        if dense.ndim == 1:                   # single example convenience
            dense = dense[None, :]
            cat = cat[:, None] if cat.ndim == 1 else cat[:, None, :]
        b = dense.shape[0]
        if cat.shape[1] != b:
            raise ValueError(f"dense batch {b} != cat batch {cat.shape[1]}")
        if b > self.max_batch:
            raise ValueError(f"request batch {b} exceeds max_batch "
                             f"{self.max_batch}; split the request")
        fut: Future = Future()
        self._q.put(_Pending(dense, cat, fut, b))
        if self._stop.is_set() and not fut.done():
            # Raced with stop(): the worker may already have run its final
            # drain, so nobody would ever read this entry. Fail it (the
            # worker guards against double-resolution on its side too).
            try:
                fut.set_exception(RuntimeError("MicroBatcher stopped"))
            except Exception:  # already resolved by the worker: fine
                pass
        return fut

    def predict(self, dense, cat, timeout: Optional[float] = None):
        """Blocking convenience wrapper around submit()."""
        return self.submit(dense, cat).result(timeout)

    def stats_snapshot(self) -> dict:
        """Consistent copy of the batching counters (the live `stats`
        fields are mutated by the worker thread)."""
        with self._stats_lock:
            st = self.stats
            return dict(requests=st.requests, examples=st.examples,
                        batches=st.batches,
                        padded_examples=st.padded_examples,
                        bucket_sizes=sorted(st.bucket_sizes))

    def stop(self, drain: bool = True, timeout: float = 30.0):
        """Stop the worker. drain=True (default) first lets queued work
        flush so in-flight Futures resolve. Anything still queued after
        `timeout` fails with RuntimeError."""
        if drain:
            deadline = time.monotonic() + timeout
            while ((not self._q.empty() or self._carry is not None)
                   and time.monotonic() < deadline
                   and self._worker.is_alive()):
                time.sleep(0.01)
        self._stop.set()
        self._q.put(None)                     # wake the worker
        self._worker.join(timeout=10)

    # -- worker side --------------------------------------------------------
    def _next_pending(self, timeout):
        if self._carry is not None:
            p, self._carry = self._carry, None
            return p
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _run(self):
        while not self._stop.is_set():
            first = self._next_pending(timeout=0.1)
            if first is None:
                continue
            batch = [first]
            size = first.size
            deadline = time.monotonic() + self.max_latency
            while size < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self._next_pending(timeout=remaining)
                if nxt is None:
                    break
                if size + nxt.size > self.max_batch:
                    self._carry = nxt         # flush now; nxt leads next batch
                    break
                batch.append(nxt)
                size += nxt.size
            self._flush(batch, size)
        # Drain: fail anything still queued so callers never hang.
        while True:
            p = self._next_pending(timeout=0)
            if p is None:
                break
            p.future.set_exception(RuntimeError("MicroBatcher stopped"))

    def _flush(self, batch, size):
        dense = np.concatenate([p.dense for p in batch], axis=0)
        cat = np.concatenate([p.cat for p in batch], axis=1)
        padded = _bucket(size, self.max_batch)
        if padded > size:
            pad = padded - size
            dense = np.concatenate(
                [dense, np.zeros((pad,) + dense.shape[1:], dense.dtype)], 0)
            cat = np.concatenate(
                [cat, np.zeros((cat.shape[0], pad) + cat.shape[2:],
                               cat.dtype)], 1)
        try:
            out = self._predict(dense, cat)
        except Exception as e:                # noqa: BLE001 — fan the error out
            for p in batch:
                p.future.set_exception(e)
            return
        # predict_fn may return one (B, ...) array or a tuple of them; each
        # is sliced per request.
        is_tuple = isinstance(out, (tuple, list))
        outs = [np.asarray(o) for o in (out if is_tuple else (out,))]
        with self._stats_lock:
            st = self.stats
            st.requests += len(batch)
            st.examples += size
            st.batches += 1
            st.padded_examples += padded - size
            st.bucket_sizes.add(padded)
        off = 0
        for p in batch:
            sl = [o[off:off + p.size] for o in outs]
            try:
                p.future.set_result(tuple(sl) if is_tuple else sl[0])
            except Exception:  # submit()'s stop-race already failed it
                pass
            off += p.size


def _scoring_service(model, make_eval_step, quantize, sharded, *,
                     quantized: bool, quantize_bits: int, mesh, axis,
                     entry: str, max_batch: int,
                     max_latency_ms: float) -> MicroBatcher:
    """A CTR model behind a `MicroBatcher`: each flushed batch is copied to
    the model's device, scored (`make_eval_step`'s step under
    `torch.inference_mode()`, or with `quantized=True` the eval function of
    `quantize(model, bits=quantize_bits)`) and copied back as numpy float32.
    Nothing synchronises explicitly: the copy back is where the worker waits
    for the batch. With a `mesh`, the family's sharded or planned model
    (`sharded()`: the sharded class and eval-step factory, then the planned
    ones, or None where the family has no planned service) behind
    `_mesh_service`; JAX's own error on a quantized mesh service comes
    first."""
    if mesh is not None:
        if quantized:
            raise NotImplementedError(
                "quantized serving is single-chip; unshard the model first")
        from .parallel.dlrm import sharded_logits, tables_device
        cls, make_sharded_eval, planned_cls, make_planned_eval = sharded()
        if isinstance(model, cls):
            step = make_sharded_eval(model.config, mesh, axis)
        elif planned_cls is not None and isinstance(model, planned_cls):
            step = make_planned_eval(model.config, mesh)
        elif planned_cls is None:
            raise NotImplementedError(
                f"{entry}(mesh=...) serves a {cls.__name__} (parallel."
                f"shard_*), got a {type(model).__name__}; a model placed by "
                "the planner (item I-3) has no mesh service here, as JAX's "
                "has none (ROADMAP.md queue 3)")
        else:
            raise NotImplementedError(
                f"{entry}(mesh=...) serves a {cls.__name__} (parallel."
                f"shard_*) or a {planned_cls.__name__} (the planner, "
                f"ROADMAP.md item I-3), got a {type(model).__name__}")
        return _mesh_service(
            tables_device(model.tables), model.tables.exchange.n,
            lambda dense, cat: sharded_logits(model, dense, cat, step),
            max_batch=max_batch, max_latency_ms=max_latency_ms)
    device = model.tables.data.device
    if quantized:
        _, score = quantize(model, bits=quantize_bits)
    else:
        step = make_eval_step(model.config)

        def score(dense, cat):
            return step(model, dense, cat)

    def predict(dense, cat):
        d = torch.from_numpy(dense).to(device)
        c = torch.from_numpy(cat).to(device)
        return score(d, c).cpu().numpy()

    return MicroBatcher(predict, max_batch=max_batch,
                        max_latency_ms=max_latency_ms)


@dataclass
class MeshFollower:
    """What a mesh service (`make_*_service(mesh=...)`) returns on the ranks
    other than 0, once rank 0's service has stopped: the batches it helped
    score."""

    batches: int


_STOP, _SCORE = 0, 1


class _MeshBatcher(MicroBatcher):
    """Rank 0's batcher of a mesh service: `stop()` also ends the other
    ranks' follower loops."""

    def __init__(self, predict_fn, header, **kw):
        super().__init__(predict_fn, **kw)
        self._header = header
        self._followers_stopped = False

    def stop(self, drain: bool = True, timeout: float = 30.0):
        super().stop(drain=drain, timeout=timeout)
        if not self._followers_stopped:
            self._followers_stopped = True
            self._header(_STOP, 0, 0, 0, 0)


def _mesh_service(device, pad_to: int, score, *, max_batch: int,
                  max_latency_ms: float):
    """A collective `score(dense, cat)` behind rank 0's `MicroBatcher`.
    Every score is a collective, so rank 0's worker broadcasts each flushed
    batch (a header with its shape, then the dense and cat tensors) to
    every rank, padded to a multiple of `pad_to` with its tail row (JAX's
    rule for a batch-sharded model; 1 for replicated queries); every rank
    scores it and rank 0 returns the result (a tensor, or a tuple of them)
    without the padding. The other ranks run that loop until rank 0's
    `stop()` and then return a `MeshFollower`."""
    import torch.distributed as dist

    def on_device():
        return (torch.cuda.device(device) if device.type == "cuda"
                else contextlib.nullcontext())

    def header(cmd, b, f, t, bag):
        h = torch.tensor([cmd, b, f, t, bag], dtype=torch.int64,
                         device=device)
        with on_device():
            dist.broadcast(h, src=0)
        return [int(x) for x in h.tolist()]

    def run(dense, cat):
        with on_device():
            dist.broadcast(dense, src=0)
            dist.broadcast(cat, src=0)
            return score(dense, cat)

    if dist.get_rank() != 0:
        batches = 0
        while True:
            cmd, b, f, t, bag = header(_STOP, 0, 0, 0, 0)
            if cmd == _STOP:
                return MeshFollower(batches)
            dense = torch.empty((b, f), dtype=torch.float32, device=device)
            cat = torch.empty((t, b) + ((bag,) if bag else ()),
                              dtype=torch.int32, device=device)
            run(dense, cat)
            batches += 1

    def predict(dense, cat):
        b = dense.shape[0]
        pad = (-b) % pad_to
        if pad:
            dense = np.concatenate([dense] + [dense[-1:]] * pad, axis=0)
            cat = np.concatenate([cat] + [cat[:, -1:]] * pad, axis=1)
        header(_SCORE, dense.shape[0], dense.shape[1], cat.shape[0],
               cat.shape[2] if cat.ndim == 3 else 0)
        out = run(torch.from_numpy(np.ascontiguousarray(dense)).to(device),
                  torch.from_numpy(np.ascontiguousarray(cat)).to(device))
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy()[:b] for o in out)
        return out.cpu().numpy()[:b]

    return _MeshBatcher(predict, header, max_batch=max_batch,
                        max_latency_ms=max_latency_ms)


def _sharded(module: str, cls: str, eval_step: str, planned=None):
    """`() -> (sharded model class, sharded eval-step factory, planned model
    class, planned eval-step factory)` of `parallel.<module>` and
    `parallel.planner` (`planned`: the planned names, or None), imported
    when a mesh asks for them."""
    def get():
        import importlib
        m = importlib.import_module(f"{__package__}.parallel.{module}")
        if planned is None:
            return getattr(m, cls), getattr(m, eval_step), None, None
        p = importlib.import_module(f"{__package__}.parallel.planner")
        return (getattr(m, cls), getattr(m, eval_step),
                getattr(p, planned[0]), getattr(p, planned[1]))
    return get


def make_dlrm_service(model, *, quantized: bool = False,
                      quantize_bits: int = 8, mesh=None, axis="data",
                      max_batch: int = 1024,
                      max_latency_ms: float = 5.0):
    """Batched DLRM scoring service on the model's device: `dlrm_forward`
    per flushed batch, or with `quantized=True` the stacked tables as int8
    (`quantize_bits=8`) or int4 rows (`quant.quantize_dlrm`). Returns a
    running `MicroBatcher`; use `.predict`/`.submit`, `.stop()` when done.

    With `mesh` (a `parallel.dlrm.ShardedDLRM` placed on it over `axis`,
    or a `parallel.planner.PlannedDLRM` on its plan) every rank of the
    group calls this: rank 0 gets the running `MicroBatcher`, whose batches
    every rank scores through the sharded or planned eval step; the other
    ranks follow until rank 0's `stop()` and then return a `MeshFollower`.
    `quantized` serving is single-device, as in JAX; `axis` is ignored
    without a mesh."""
    return _scoring_service(model, dlrm.make_eval_step, quant.quantize_dlrm,
                            _sharded("dlrm", "ShardedDLRM",
                                     "make_sharded_eval_step",
                                     ("PlannedDLRM", "make_planned_eval_step")),
                            quantized=quantized,
                            quantize_bits=quantize_bits, mesh=mesh, axis=axis,
                            entry="make_dlrm_service", max_batch=max_batch,
                            max_latency_ms=max_latency_ms)


def make_dcn_service(model, *, quantized: bool = False,
                     quantize_bits: int = 8, mesh=None, axis="data",
                     max_batch: int = 1024,
                     max_latency_ms: float = 5.0) -> MicroBatcher:
    """Batched DCN-v2 scoring service, `make_dlrm_service`'s contract for a
    `models.dcn.DCN` (`quant.quantize_dcn`), or with `mesh` a
    `parallel.dcn.ShardedDCN` or a `parallel.planner.PlannedDCN`."""
    return _scoring_service(model, dcn.make_eval_step, quant.quantize_dcn,
                            _sharded("dcn", "ShardedDCN",
                                     "make_sharded_dcn_eval_step",
                                     ("PlannedDCN",
                                      "make_planned_dcn_eval_step")),
                            quantized=quantized,
                            quantize_bits=quantize_bits, mesh=mesh, axis=axis,
                            entry="make_dcn_service", max_batch=max_batch,
                            max_latency_ms=max_latency_ms)


def make_deepfm_service(model, *, quantized: bool = False,
                        quantize_bits: int = 8, mesh=None, axis="data",
                        max_batch: int = 1024,
                        max_latency_ms: float = 5.0) -> MicroBatcher:
    """Batched DeepFM scoring service (either layout),
    `make_dlrm_service`'s contract for a `models.deepfm.DeepFM`
    (`quant.quantize_deepfm`: the folded stack quantizes its fused rows,
    so `quantize_bits=4` raises there; the unfolded first-order stack stays
    in its storage dtype), or with `mesh` a `parallel.deepfm.ShardedDeepFM`;
    a `PlannedDeepFM` is refused, as JAX's service has no planned branch
    (ROADMAP.md queue 3)."""
    return _scoring_service(model, deepfm.make_eval_step,
                            quant.quantize_deepfm,
                            _sharded("deepfm", "ShardedDeepFM",
                                     "make_sharded_deepfm_eval_step"),
                            quantized=quantized, quantize_bits=quantize_bits,
                            mesh=mesh, axis=axis, entry="make_deepfm_service",
                            max_batch=max_batch,
                            max_latency_ms=max_latency_ms)


def make_retrieval_service(model, *, k: int = 10, mesh=None, axis="data",
                           max_batch: int = 1024,
                           max_latency_ms: float = 5.0) -> MicroBatcher:
    """Batched two-tower top-k retrieval service on the model's device.

    Builds the item index once (`build_item_index`) and one retriever
    (`make_retriever`); requests coalesce through the MicroBatcher, the
    `cat` argument of `submit`/`predict` being the `(T, b)` query features.
    Each request resolves to `(scores (b, k) float32, item_ids (b, k)
    int32)`. With `mesh` every rank calls it with the same `TwoTower` (a
    `parallel.two_tower.ShardedTwoTower` is unsharded first): the index is
    block-row sharded over `axis` (`build_sharded_item_index`, each rank
    embedding its own rows) and rank 0's batches are broadcast to every
    rank for the sharded retriever; the other ranks follow until rank 0's
    `stop()` (`make_dlrm_service`'s contract); `axis` is ignored without
    a mesh, as in JAX."""
    if mesh is not None:
        from .parallel import two_tower as ptt
        if isinstance(model, ptt.ShardedTwoTower):
            model = ptt.unshard_two_tower(model)
        index = ptt.build_sharded_item_index(model, mesh, axis)
        sharded = ptt.make_sharded_retriever(model, mesh, k=k, axis=axis)
        return _mesh_service(model.item_data.device, 1,
                             lambda dense, cat: sharded(index, dense, cat),
                             max_batch=max_batch,
                             max_latency_ms=max_latency_ms)
    index = two_tower.build_item_index(model)
    run = two_tower.make_retriever(model, k=k)

    def predict(dense, cat):
        return tuple(o.cpu().numpy() for o in run(index, dense, cat))

    return MicroBatcher(predict, max_batch=max_batch,
                        max_latency_ms=max_latency_ms)


# ---------------------------------------------------------------------------
# Refreshable serving
# ---------------------------------------------------------------------------

def _ctr_eval_step_for(model):
    """The eval step of whichever CTR family `model` is (DLRM, DCN or
    DeepFM): the only family-specific piece of refreshable serving."""
    if isinstance(model, dlrm.DLRM):
        return dlrm.make_eval_step(model.config)
    if isinstance(model, dcn.DCN):
        return dcn.make_eval_step(model.config)
    if isinstance(model, deepfm.DeepFM):
        return deepfm.make_eval_step(model.config)
    raise TypeError(
        f"refreshable serving covers the CTR families (DLRM/DCN/DeepFM); "
        f"got {type(model).__name__}")


def _with_tables(model, data: torch.Tensor):
    """A shallow copy of `model` that shares its towers and holds a new
    `StackedTables` over `data`: setting it writes nothing of `model`."""
    served = copy.copy(model)
    # copy.copy shares the module's registries; give the copy its own, so
    # that its new tables do not land in `model`.
    served._modules = dict(model._modules)
    served._buffers = dict(model._buffers)
    served._parameters = dict(model._parameters)
    old = model.tables
    served._modules["tables"] = StackedTables(data, old.offsets, old.dim)
    return served


def make_refreshable_service(model, *, max_batch: int = 1024,
                             max_latency_ms: float = 5.0):
    """Online-refresh CTR scoring for any family (DLRM, DCN, DeepFM):
    returns `(batcher, swap)`.

    The service scores with its own view of the model, held in a one-slot
    holder that each flushed batch reads once, so a batch in flight scores
    wholly with the old model or wholly with the new one, never a mix.
    `swap(new_model)` replaces the served model; `batcher.swap_tables(data)`
    serves a new stacked table tensor (a `DeltaFollower`'s `data`) with the
    served towers, through a shallow copy of the model: a trainer that
    updates `model` in place in the same process never writes into what is
    served, and nothing the service reads is written. DeepFM's folded
    layout works as it is: the fused stack is `model.tables`, so one
    tensor carries the first-order weights and the FM vectors.

        batcher, swap = make_refreshable_service(model)
        follower = DeltaFollower(ckpt_dir, model.tables.data)
        ... every refresh interval:
        if follower.poll():
            batcher.swap_tables(follower.data)
    """
    step = _ctr_eval_step_for(model)
    device = model.tables.data.device
    holder = {"model": _with_tables(model, model.tables.data)}

    def predict(dense, cat):
        served = holder["model"]      # one read: one model for the batch
        d = torch.from_numpy(dense).to(device)
        c = torch.from_numpy(cat).to(device)
        return step(served, d, c).cpu().numpy()

    batcher = MicroBatcher(predict, max_batch=max_batch,
                           max_latency_ms=max_latency_ms)

    def swap(new_model):
        holder["model"] = new_model

    def swap_tables(data: torch.Tensor):
        """Serve `data` as the stacked table, keeping the served towers."""
        holder["model"] = _with_tables(holder["model"], data)

    batcher.swap = swap
    batcher.swap_tables = swap_tables
    return batcher, swap


def make_refreshable_dlrm_service(model, *, max_batch: int = 1024,
                                  max_latency_ms: float = 5.0):
    """Online-refresh DLRM scoring: `make_refreshable_service`, JAX's
    original DLRM entry point (an alias)."""
    return make_refreshable_service(model, max_batch=max_batch,
                                    max_latency_ms=max_latency_ms)


# ---------------------------------------------------------------------------
# Stdlib HTTP harness
# ---------------------------------------------------------------------------

def serve_http(batcher: MicroBatcher, host: str = "127.0.0.1",
               port: int = 0) -> ThreadingHTTPServer:
    """JSON-over-HTTP front end for a MicroBatcher (started; not blocking).

    POST /predict  {"dense": [[...], ...], "cat": [[...], ...]}
                -> {"scores": [...]}            (shapes as module docstring)
    GET  /stats -> batching counters.

    Returns the server; `server.server_address[1]` is the bound port and
    `server.shutdown()` stops it. Each HTTP thread just blocks on its
    request's Future; batching happens in the MicroBatcher worker.
    """

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):            # quiet
            pass

        def _reply(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/stats":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, batcher.stats_snapshot())

        def do_POST(self):
            if self.path != "/predict":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                out = batcher.predict(req["dense"], req["cat"], timeout=30.0)
                self._reply(200, {"scores": np.asarray(out).tolist()})
            except Exception as e:            # noqa: BLE001 — surface to client
                self._reply(400, {"error": str(e)})

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="serving-http").start()
    return server

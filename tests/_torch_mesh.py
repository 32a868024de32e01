"""Spawned gloo ranks for the port's mesh tests.

`MeshPool(n, directory)` starts n processes that join one gloo group
through a `FileStore` in `directory` (no TCP port, so parallel test workers
do not collide) and build the 1-D `("data",)` mesh and the `(2, 2)`
`("data", "model")` mesh. `pool.run(name, *args)` then runs the function
`name` of this module on every rank at once, `fn(ctx, *args)`, and returns
the ranks' results in rank order. The ranks import torch and the port only,
never JAX: the tests compute JAX's side in their own process. A rank that
raises, or ranks that do not answer within `TIMEOUT` seconds, fail the call;
the ranks are then killed and the next call starts a new group.

Each rank runs one torch thread. The functions below take numpy arrays and
return numpy arrays (or plain values), so nothing but data crosses.
"""
import multiprocessing
import os
import queue
import time
import traceback

import numpy as np

TIMEOUT = 120.0


class Ctx:
    """What a rank's functions see: its rank, the world size and the
    meshes (`ctx.mesh(axis)` picks the one a placement axis needs): the
    1-D mesh, and as the 2-D one the row-major `(2, n/2)` grid or, after
    `use_mesh("hosts")`, `multihost_mesh`'s host-major grid of 2 ranks a
    host (rank `h * 2 + i` at `(i, h)`)."""

    def __init__(self, rank: int, n: int):
        from embeddingtables_tpu_torch.parallel import mesh as pmesh
        self.rank, self.n = rank, n
        self.mesh1 = pmesh.local_mesh(n, ("data",), device="cpu")
        self.grid = pmesh.default_mesh(("data", "model"), shape=(2, n // 2),
                                       device="cpu")
        self.hosts = pmesh.multihost_mesh(("data", "model"), device="cpu",
                                          local_size=2)
        self.mesh2 = self.grid

    def mesh(self, axis):
        return self.mesh1 if isinstance(axis, str) else self.mesh2


def use_mesh(ctx, kind):
    """The 2-D mesh the next calls use: "grid" or "hosts"."""
    ctx.mesh2 = getattr(ctx, kind)


def _worker(rank, n, store, inbox, outbox):
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from embeddingtables_tpu_torch.parallel import mesh as pmesh
    try:
        pmesh.init_process(f"file://{store}", n, rank, device="cpu")
        ctx = Ctx(rank, n)
    except BaseException:
        outbox.put((rank, ("err", traceback.format_exc())))
        return
    outbox.put((rank, ("ok", "ready")))
    while True:
        msg = inbox.get()
        if msg is None:
            break
        name, args, kwargs = msg
        try:
            out = ("ok", globals()[name](ctx, *args, **kwargs))
        except BaseException:
            out = ("err", traceback.format_exc())
        outbox.put((rank, out))
    dist.destroy_process_group()


class MeshPool:
    def __init__(self, n: int, directory: str):
        self.n, self.directory = n, directory
        self.generation = 0
        self.procs = []

    def _start(self):
        mp = multiprocessing.get_context("spawn")
        self.generation += 1
        store = os.path.join(self.directory, f"store{self.generation}")
        self.outbox = mp.Queue()
        self.inboxes = [mp.Queue() for _ in range(self.n)]
        self.procs = [mp.Process(target=_worker, daemon=True,
                                 args=(r, self.n, store, self.inboxes[r],
                                       self.outbox))
                      for r in range(self.n)]
        for p in self.procs:
            p.start()
        self._collect("start")

    def _collect(self, name):
        got = {}
        deadline = time.monotonic() + TIMEOUT
        while len(got) < self.n:
            left = deadline - time.monotonic()
            try:
                rank, out = self.outbox.get(timeout=max(left, 0.01))
            except queue.Empty:
                self.close(kill=True)
                raise AssertionError(f"mesh ranks did not answer {name} "
                                     f"within {TIMEOUT:.0f} s") from None
            if out[0] == "err":
                self.close(kill=True)
                raise AssertionError(f"rank {rank} failed in {name}:\n"
                                     f"{out[1]}")
            got[rank] = out[1]
        return [got[r] for r in range(self.n)]

    def run(self, name: str, *args, **kwargs) -> list:
        if not self.procs or not all(p.is_alive() for p in self.procs):
            self.close(kill=True)
            self._start()
        for q in self.inboxes:
            q.put((name, args, kwargs))
        return self._collect(name)

    def close(self, kill: bool = False):
        for p, q in zip(self.procs, getattr(self, "inboxes", [])):
            if p.is_alive() and not kill:
                q.put(None)
        for p in self.procs:
            if kill and p.is_alive():
                p.kill()
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.procs = []


# ---------------------------------------------------------------------------
# Rank functions: fn(ctx, *args) on every rank
# ---------------------------------------------------------------------------

def _t(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return None if t is None else t.detach().float().cpu().numpy()


def _st(ctx, axis, table):
    from embeddingtables_tpu_torch.parallel import ShardedStackedTables
    from embeddingtables_tpu_torch.ops.ensemble import StackedTables
    if isinstance(table, tuple):                   # (data, offsets)
        data, offsets = table
        table = StackedTables(_t(data), offsets, data.shape[1])
    else:
        table = _t(table)
    return ShardedStackedTables.shard(ctx.mesh(axis), axis, table)


def layout(ctx, axis, table):
    """This rank's flat index, its shard, and the unsharded table."""
    st = _st(ctx, axis, table)
    return {"me": st.exchange.me, "shard": _np(st.data),
            "full": _np(st.unshard()), "order": st.exchange.order}


def _block(ctx, axis, x, dim=0):
    from embeddingtables_tpu_torch.parallel.sharded import Exchange
    ex = Exchange(ctx.mesh(axis), axis)
    b = x.shape[dim] // ex.n_data
    sl = slice(ex.data_index * b, (ex.data_index + 1) * b)
    return x[sl] if dim == 0 else x[:, sl]


def lookup(ctx, axis, table, idx, kw, ensemble=False):
    """`sharded_lookup` (or `sharded_ensemble_lookup`) of this rank's block
    of `idx`; returns the block's rows."""
    from embeddingtables_tpu_torch.parallel import (sharded_ensemble_lookup,
                                                    sharded_lookup)
    st = _st(ctx, axis, table)
    dim = 1 if ensemble else 0
    kw = dict(kw)
    if kw.get("weights") is not None:
        kw["weights"] = _t(_block(ctx, axis, kw["weights"], dim))
    local = _t(_block(ctx, axis, idx, dim))
    if ensemble:
        out = sharded_ensemble_lookup(ctx.mesh(axis), st, local, **kw)
    else:
        out = sharded_lookup(ctx.mesh(axis), st, local, **kw)
    return [_np(o) for o in out] if isinstance(out, list) else _np(out)


def sgd_update(ctx, axis, table, upd, lr, ensemble=False):
    """`sharded_sgd_update` / `sharded_ensemble_update` of this rank's block
    of `upd` (`dict(delta=, indices=, weights=)`, or a list of them)."""
    from embeddingtables_tpu_torch.ops.sparse_update import \
        SparseEmbeddingUpdate
    from embeddingtables_tpu_torch.parallel import (sharded_ensemble_update,
                                                    sharded_sgd_update)
    st = _st(ctx, axis, table)

    def local(u):
        return SparseEmbeddingUpdate(
            delta=_t(_block(ctx, axis, u["delta"])),
            indices=_t(_block(ctx, axis, u["indices"])),
            weights=None if u.get("weights") is None
            else _t(_block(ctx, axis, u["weights"])))

    if ensemble:
        sharded_ensemble_update(ctx.mesh(axis), st, [local(u) for u in upd],
                                lr)
    else:
        sharded_sgd_update(ctx.mesh(axis), st, local(upd), lr)
    return _np(st.unshard())


def lookup_a2a(ctx, axis, table, idx, kw):
    """`sharded_lookup_a2a` of this rank's block: `(rows, overflow)`."""
    import torch
    from embeddingtables_tpu_torch.parallel import sharded_lookup_a2a
    st = _st(ctx, axis, table)
    kw = dict(kw)
    if kw.get("weights") is not None:
        kw["weights"] = _t(_block(ctx, axis, kw["weights"]))
    if kw.get("wire_dtype") == "bfloat16":
        kw["wire_dtype"] = torch.bfloat16
    out, ovf = sharded_lookup_a2a(ctx.mesh(axis), st,
                                  _t(_block(ctx, axis, idx)), **kw)
    return _np(out), int(ovf)


def update_a2a(ctx, axis, table, upd, opt, kw):
    """`sharded_update_a2a` with `opt` from its fresh state: the unsharded
    table and state, and the overflow."""
    import torch
    from embeddingtables_tpu_torch.ops.sparse_update import \
        SparseEmbeddingUpdate
    from embeddingtables_tpu_torch.parallel import (shard_row_accum,
                                                    sharded_update_a2a,
                                                    unshard_row_state)
    st = _st(ctx, axis, table)
    local_state = shard_row_accum(ctx.mesh(axis), axis, st,
                                  opt.init(_t(table)), opt)
    u = SparseEmbeddingUpdate(
        delta=_t(_block(ctx, axis, upd["delta"])),
        indices=_t(_block(ctx, axis, upd["indices"])))
    kw = dict(kw)
    if kw.get("wire_dtype") == "bfloat16":
        kw["wire_dtype"] = torch.bfloat16
    local_state, ovf = sharded_update_a2a(ctx.mesh(axis), st, local_state, u,
                                          opt, **kw)
    back = unshard_row_state(st, local_state)
    return _np(st.unshard()), [_np(s) for s in back], int(ovf)


def fresh_state(ctx, axis, table, opt):
    """`shard_row_accum` of SGD's empty state for `opt`: this rank's
    state fields."""
    from embeddingtables_tpu_torch.optim import SparseSGD
    from embeddingtables_tpu_torch.parallel import shard_row_accum
    st = _st(ctx, axis, table)
    state = shard_row_accum(ctx.mesh(axis), axis, st,
                            SparseSGD().init(st.data), opt)
    return [_np(s) for s in state]


def owned_stream(ctx, axis, table, upd, lr):
    """The gather exchange's SGD update, and on each rank the same owned
    occurrences (in stream order) through the single-device run-scatter:
    `(sharded shard, run-scatter shard)`, bitwise equal by design."""
    import torch
    from embeddingtables_tpu_torch.ops.cuda.scatter import scatter_update
    from embeddingtables_tpu_torch.ops.sparse_update import \
        SparseEmbeddingUpdate
    from embeddingtables_tpu_torch.parallel import sharded_sgd_update
    st = _st(ctx, axis, table)
    before = st.data.clone()
    ex = st.exchange
    sharded_sgd_update(ctx.mesh(axis), st, SparseEmbeddingUpdate(
        delta=_t(_block(ctx, axis, upd["delta"])),
        indices=_t(_block(ctx, axis, upd["indices"]))), lr)
    rows = torch.from_numpy(upd["indices"]).long()
    keep = (rows % ex.n) == ex.me
    ref = before.clone()
    scatter_update(ref, (rows[keep] // ex.n).to(torch.int32),
                   torch.from_numpy(upd["delta"])[keep].float(), -float(lr))
    return _np(st.data), _np(ref)


# ---------------------------------------------------------------------------
# The sharded DLRM
# ---------------------------------------------------------------------------

def _dlrm(ctx, axis, cfg, arrays, opt, dense_tx=None):
    from embeddingtables_tpu_torch.interop import dlrm_from_arrays
    from embeddingtables_tpu_torch.parallel import shard_dlrm
    model = dlrm_from_arrays(cfg, device="cpu", **arrays)
    return shard_dlrm(model, ctx.mesh(axis), axis, sparse_opt=opt,
                      dense_tx=dense_tx)


def _unsharded(model):
    from embeddingtables_tpu_torch.parallel import unshard_dlrm
    m = unshard_dlrm(model)
    return {"tables": _np(m.tables.data),
            "state": [_np(s) for s in m.emb_state],
            "towers": [_np(p) for _, p in m.named_parameters()]}


def dlrm_steps(ctx, axis, cfg, arrays, opt, batches, step_kw):
    """`make_sharded_train_step(**step_kw)` for each `(dense, cat, label)`
    global batch, each rank on its block: the losses (and overflows), then
    the unsharded model."""
    from embeddingtables_tpu_torch.parallel import (local_batch,
                                                    make_sharded_train_step)
    mesh = ctx.mesh(axis)
    model = _dlrm(ctx, axis, cfg, arrays, opt,
                  dense_tx=step_kw.get("dense_tx"))
    step = make_sharded_train_step(cfg, mesh, axis, sparse_opt=opt,
                                   dense_lr=0.1, **step_kw)
    losses, overflows = [], []
    for dense, cat, label in batches:
        d, c, l = local_batch(mesh, axis, _t(dense), _t(cat), _t(label))
        out = step(model, d, c, l)
        if isinstance(out, tuple):
            overflows.append(int(out[1]))
            out = out[0]
        losses.append(float(out))
    return {"losses": losses, "overflows": overflows, **_unsharded(model)}


def dlrm_eval(ctx, axis, cfg, arrays, dense, cat):
    """The sharded eval of a global batch, gathered on every rank."""
    from embeddingtables_tpu_torch.parallel.dlrm import sharded_logits
    model = _dlrm(ctx, axis, cfg, arrays, None)
    return _np(sharded_logits(model, _t(dense), _t(cat)))


def train_loop(ctx, axis, cfg, arrays, opt, batches, kw):
    """`train_dlrm(mesh=...)` over the global batches: losses, AUCs, the
    unsharded model, and the capacity tuner's factor."""
    from embeddingtables_tpu_torch.models.train import train_dlrm
    kw = dict(kw)
    model = None if arrays is None else dict(arrays)
    res = train_dlrm(cfg, iter([dict(dense=d, cat=c, label=l)
                                for d, c, l in batches]), len(batches),
                     model=model, mesh=ctx.mesh(axis), axis=axis,
                     sparse_opt=opt, device="cpu", verbose=False, **kw)
    out = {"losses": res.losses, "aucs": res.aucs, **_unsharded(res.model)}
    return out


def serve(ctx, axis, cfg, arrays, requests):
    """`make_dlrm_service(mesh=...)`: rank 0 answers `requests` through its
    MicroBatcher and stops; the other ranks follow until then. Rank 0
    returns the scores, the others the batches they followed."""
    import torch.distributed as dist
    from embeddingtables_tpu_torch.serving import make_dlrm_service
    model = _dlrm(ctx, axis, cfg, arrays, None)
    svc = make_dlrm_service(model, mesh=ctx.mesh(axis), axis=axis,
                            max_batch=16, max_latency_ms=2.0)
    if dist.get_rank() != 0:
        return svc.batches
    try:
        return [svc.predict(d, c, timeout=60) for d, c in requests]
    finally:
        svc.stop()


def sr_update(ctx, table, upd, lr):
    """SGD with stochastic rounding on a bf16 shard, each rank with its own
    generator: this rank's shard before and after, and the f32 values the
    rounding started from (the same update on an f32 copy)."""
    import torch
    from embeddingtables_tpu_torch.optim import SparseSGD
    from embeddingtables_tpu_torch.parallel.dlrm import rank_generator
    from embeddingtables_tpu_torch.parallel.sharded import owned_apply
    st = _st(ctx, "data", table)
    st.data = st.data.to(torch.bfloat16)
    f32 = _st(ctx, "data", table)
    f32.data = st.data.float()
    before = f32.data.clone()
    idx = _t(_block(ctx, "data", upd["indices"]))
    delta = _t(_block(ctx, "data", upd["delta"]))
    owned_apply(f32, idx, delta, None, SparseSGD(lr), SparseSGD().init(
        f32.data))
    opt = SparseSGD(lr, stochastic_rounding=True)
    owned_apply(st, idx, delta, None, opt, opt.init(st.data),
                generator=rank_generator(0, st.exchange.me, "cpu"))
    return _np(before), _np(st.data), _np(f32.data)


def init_sharded(ctx, axis, cfg, batches):
    """`init_sharded_dlrm` and one step: this rank's shard rows, its first
    value, and the loss."""
    from embeddingtables_tpu_torch.parallel import (init_sharded_dlrm,
                                                    local_batch,
                                                    make_sharded_train_step)
    mesh = ctx.mesh(axis)
    model = init_sharded_dlrm(cfg, mesh, axis, seed=3)
    first = float(model.tables.data[0, 0])
    step = make_sharded_train_step(cfg, mesh, axis)
    (dense, cat, label), = batches
    loss = step(model, *local_batch(mesh, axis, _t(dense), _t(cat),
                                    _t(label)))
    return {"rows": model.tables.data.shape[0], "first_row": first,
            "loss": float(loss)}

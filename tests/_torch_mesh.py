"""Spawned gloo ranks for the port's mesh tests.

`MeshPool(n, directory)` starts n processes that join one gloo group
through a `FileStore` in `directory` (no TCP port, so parallel test workers
do not collide) and build the 1-D `("data",)` mesh and the `(2, 2)`
`("data", "model")` mesh. `pool.run(name, *args)` then runs the function
`name` of this module on every rank at once, `fn(ctx, *args)`, and returns
the ranks' results in rank order; `pool.submit(name, *args)` starts the
same and returns a function that waits for those results, so a test can
compute JAX's side while the ranks run. The ranks import torch and the port only,
never JAX: the tests compute JAX's side in their own process. A rank that
raises, or ranks that do not answer within `TIMEOUT` seconds, fail the call;
the ranks are then killed and the next call starts a new group.

Each rank runs one torch thread. The functions below take numpy arrays and
return numpy arrays (or plain values), so nothing but data crosses.
"""
import multiprocessing
import os
import pickle
import queue
import time
import traceback

import numpy as np
from multiprocessing.reduction import ForkingPickler

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
        if n % 2 == 0:
            self.grid = pmesh.default_mesh(("data", "model"),
                                           shape=(2, n // 2), device="cpu")
            self.hosts = pmesh.multihost_mesh(("data", "model"),
                                              device="cpu", local_size=2)
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
        outbox.put((rank, "ready", ("err", traceback.format_exc())))
        return
    outbox.put((rank, "ready", ("ok", "ready")))
    while True:
        msg = inbox.get()
        if msg is None:
            break
        name, args, kwargs = pickle.loads(msg)
        try:
            out = ("ok", globals()[name](ctx, *args, **kwargs))
        except BaseException:
            out = ("err", traceback.format_exc())
        outbox.put((rank, "result", out))
    dist.destroy_process_group()


class MeshPool:
    def __init__(self, n: int, directory: str):
        """Spawn the n ranks now; they join their group while the caller
        goes on (the first result waits for them)."""
        self.n, self.directory = n, directory
        self.generation = 0
        self.procs = []
        self._starting = False
        self._early = {}
        self._start()

    def _start(self):
        """Spawn the ranks; their "ready" is collected before the first
        result (`_starting`)."""
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
        self._starting = True
        self._early = {}

    def _collect(self, name, kind="result"):
        """The n ranks' messages of `kind` ("ready" or "result"); a result
        that comes before every rank is ready waits in `_early`."""
        got = {}
        if kind == "result":
            got, self._early = self._early, {}
        deadline = time.monotonic() + TIMEOUT
        while len(got) < self.n:
            left = deadline - time.monotonic()
            try:
                rank, k, out = self.outbox.get(timeout=max(left, 0.01))
            except queue.Empty:
                self.close(kill=True)
                raise AssertionError(f"mesh ranks did not answer {name} "
                                     f"within {TIMEOUT:.0f} s") from None
            if out[0] == "err":
                self.close(kill=True)
                raise AssertionError(f"rank {rank} failed in {name}:\n"
                                     f"{out[1]}")
            if k != kind:
                self._early[rank] = out[1]
                continue
            got[rank] = out[1]
        return [got[r] for r in range(self.n)]

    def submit(self, name: str, *args, **kwargs):
        """Start `name` on every rank; returns `result()`, which waits for
        the ranks' results (call it before the next submit)."""
        if not self.procs or not all(p.is_alive() for p in self.procs):
            self.close(kill=True)
            self._start()
        # Pickled now: the queue's feeder thread would pickle later, after
        # the caller may have reused the arrays (JAX donates its buffers).
        msg = bytes(ForkingPickler.dumps((name, args, kwargs)))
        for q in self.inboxes:
            q.put(msg)

        def result() -> list:
            if self._starting:
                self._collect("start", "ready")
                self._starting = False
            return self._collect(name)
        return result

    def run(self, name: str, *args, **kwargs) -> list:
        return self.submit(name, *args, **kwargs)()

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
    """`train_dlrm(mesh=...)` over the global batches, under a telemetry of
    its own: losses, AUCs, the unsharded model, and how often each
    telemetry phase opened."""
    from embeddingtables_tpu_torch.models.train import train_dlrm
    from embeddingtables_tpu_torch.utils import telemetry
    kw = dict(kw)
    model = None if arrays is None else dict(arrays)
    tel = telemetry.Telemetry()
    old = telemetry.set_telemetry(tel)
    try:
        res = train_dlrm(cfg, iter([dict(dense=d, cat=c, label=l)
                                    for d, c, l in batches]), len(batches),
                         model=model, mesh=ctx.mesh(axis), axis=axis,
                         sparse_opt=opt, device="cpu", verbose=False, **kw)
    finally:
        telemetry.set_telemetry(old)
    out = {"losses": res.losses, "aucs": res.aucs, **_unsharded(res.model),
           "phases": {k: v.count for k, v in tel.phases.items()}}
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


# ---------------------------------------------------------------------------
# Every family on the mesh (DCN, DeepFM, the two-tower model; the DLRM too)
# ---------------------------------------------------------------------------

FAMILIES = ("dlrm", "dcn", "deepfm", "two_tower")


def _family_model(family, cfg, arrays):
    """The single-device model from `*_from_arrays`'s keyword arguments."""
    import embeddingtables_tpu_torch as ett
    return getattr(ett, f"{family}_from_arrays")(cfg, device="cpu", **arrays)


def _sharded_api(family):
    """(shard, train-step factory, eval-step factory or None, unshard)."""
    from embeddingtables_tpu_torch import parallel as P
    return {"dlrm": (P.shard_dlrm, P.make_sharded_train_step,
                     P.make_sharded_eval_step, P.unshard_dlrm),
            "dcn": (P.shard_dcn, P.make_sharded_dcn_train_step,
                    P.make_sharded_dcn_eval_step, P.unshard_dcn),
            "deepfm": (P.shard_deepfm, P.make_sharded_deepfm_train_step,
                       P.make_sharded_deepfm_eval_step, P.unshard_deepfm),
            "two_tower": (P.shard_two_tower, P.make_sharded_tt_train_step,
                          None, P.unshard_two_tower)}[family]


def _shard(ctx, axis, family, model, opt, dense_tx=None):
    shard = _sharded_api(family)[0]
    kw = {} if family == "two_tower" else {"dense_tx": dense_tx}
    return shard(model, ctx.mesh(axis), axis, sparse_opt=opt, **kw)


def model_out(m):
    """A single-device model's tables, row states and towers as numpy."""
    if hasattr(m, "query_tables"):
        return {"tables": _np(m.query_tables.data),
                "items": _np(m.item_data),
                "state": [_np(s) for s in m.q_state]
                + [_np(s) for s in m.i_state],
                "towers": [_np(p) for p in m.parameters()]}
    out = {"tables": _np(m.tables.data),
           "state": [_np(s) for s in m.emb_state],
           "towers": [_np(p) for _, p in m.tower_params()]}
    if getattr(m, "fm_w", None) is not None:
        out["fm"] = _np(m.fm_w.data)
        out["state"] += [_np(s) for s in m.fm_state]
    return out


def _step(family, cfg, mesh, axis, opt, step_kw):
    make = _sharded_api(family)[1]
    if family == "two_tower":
        return make(cfg, mesh, axis, sparse_opt=opt, dense_lr=0.1)
    return make(cfg, mesh, axis, sparse_opt=opt, dense_lr=0.1, **step_kw)


def family_steps(ctx, axis, family, cfg, arrays, opt, batches, step_kw=None):
    """The family's sharded step on each global batch, each rank on its
    block (`batch_shardings`): the losses (and the two-tower model's
    accuracies), then the unsharded model."""
    from embeddingtables_tpu_torch.parallel import batch_shardings
    mesh = ctx.mesh(axis)
    step_kw = dict(step_kw or {})
    sm = _shard(ctx, axis, family, _family_model(family, cfg, arrays), opt,
                step_kw.get("dense_tx"))
    step = _step(family, cfg, mesh, axis, opt, step_kw)
    shardings = batch_shardings(mesh, axis)
    losses, accs = [], []
    for batch in batches:
        out = step(sm, *(f(_t(x)) for f, x in zip(shardings, batch)))
        if isinstance(out, tuple):
            accs.append(float(out[1]))
            out = out[0]
        losses.append(float(out))
    return {"losses": losses, "accs": accs,
            **model_out(_sharded_api(family)[3](sm))}


def family_bitwise(ctx, family, cfg, arrays, opt, batches):
    """On a one-rank group: the sharded step and the single-device step
    from the same weights on the same batches. Returns the names of what
    is not bitwise equal (empty when everything is)."""
    import torch
    import embeddingtables_tpu_torch as ett
    single = _family_model(family, cfg, arrays)
    sm = _shard(ctx, "data", family, _family_model(family, cfg, arrays), opt)
    step = _step(family, cfg, ctx.mesh1, "data", opt, {})
    if family == "two_tower":
        step1 = ett.models.two_tower.make_train_step(cfg, sparse_opt=opt,
                                                     dense_lr=0.1)
    else:
        step1 = getattr(ett.models, {"dlrm": "make_train_step",
                                     "dcn": "make_dcn_train_step",
                                     "deepfm": "make_deepfm_train_step"}[
            family])(cfg, sparse_opt=opt, dense_lr=0.1)
    bad = []
    for i, batch in enumerate(batches):
        args = [_t(x) for x in batch]
        a, b = step(sm, *args), step1(single, *args)
        a, b = (a if isinstance(a, tuple) else (a,)), \
            (b if isinstance(b, tuple) else (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            bad.append(f"loss {i}")
    got, want = model_out(_sharded_api(family)[3](sm)), model_out(single)
    for k in want:
        for j, (x, y) in enumerate(zip(*(
                (v if isinstance(v, list) else [v]) for v in (got[k],
                                                              want[k])))):
            if not np.array_equal(x, y):
                bad.append(f"{k} {j}")
    return bad


def family_eval(ctx, axis, family, cfg, arrays, dense, cat):
    """The family's sharded eval of a global batch, gathered on every
    rank."""
    from embeddingtables_tpu_torch.parallel.dlrm import sharded_logits
    sm = _shard(ctx, axis, family, _family_model(family, cfg, arrays), None)
    step = _sharded_api(family)[2](cfg, ctx.mesh(axis), axis)
    return _np(sharded_logits(sm, _t(dense), _t(cat), step))


def family_loop(ctx, axis, family, cfg, arrays, opt, batches, kw):
    """`train_<family>(mesh=...)` over the global batches, from the weights
    in `arrays`: losses, evals and the unsharded model. Path keywords
    become managers: `ckpt_dir` a `CheckpointManager` (with `guard` the
    `DivergenceGuard` over it), `delta_dir` a `DeltaCheckpointManager` (a
    pair of directories for the two-tower model)."""
    from embeddingtables_tpu_torch.models import train as T
    from embeddingtables_tpu_torch.utils import (CheckpointManager,
                                                 DeltaCheckpointManager,
                                                 DivergenceGuard)
    kw = dict(kw)
    ckpt = kw.pop("ckpt_dir", None)
    if ckpt is not None:
        kw["ckpt_manager"] = CheckpointManager(ckpt)
        if kw.pop("guard", False):
            guard = kw["guard"] = DivergenceGuard(kw["ckpt_manager"])
    delta = kw.pop("delta_dir", None)
    if delta is not None:
        base_every = kw.pop("base_every", 8)
        kw["delta_ckpt"] = (
            tuple(DeltaCheckpointManager(d, base_every=base_every)
                  for d in delta) if isinstance(delta, (list, tuple))
            else DeltaCheckpointManager(delta, base_every=base_every))
    keys = (("dense", "q_cat", "item_ids") if family == "two_tower"
            else ("dense", "cat", "label"))
    res = getattr(T, f"train_{family}")(
        cfg, iter([dict(zip(keys, b)) for b in batches]), len(batches),
        model=None if arrays is None else dict(arrays), mesh=ctx.mesh(axis),
        axis=axis, sparse_opt=opt, device="cpu", verbose=False, **kw)
    m = res.model
    if family != "two_tower":
        m = _sharded_api(family)[3](m)
    out = {"losses": res.losses, **model_out(m)}
    out["evals"] = res.recalls if family == "two_tower" else res.aucs
    if family == "two_tower":
        out["accs"] = res.accs
    else:
        out["evicted"] = res.evicted_rows
    if "guard" in kw:
        out["rollbacks"] = guard.rollbacks
    return out


def family_serve(ctx, axis, family, cfg, arrays, requests, k=5):
    """`make_<family>_service(mesh=...)` (`make_retrieval_service` for the
    two-tower model, from its single-device model): rank 0 answers
    `requests` and stops; the other ranks follow until then. Rank 0
    returns the answers, the others the batches they followed."""
    import torch.distributed as dist
    import embeddingtables_tpu_torch as ett
    model = _family_model(family, cfg, arrays)
    kw = dict(mesh=ctx.mesh(axis), axis=axis, max_batch=16,
              max_latency_ms=2.0)
    if family == "two_tower":
        svc = ett.make_retrieval_service(model, k=k, **kw)
    else:
        svc = getattr(ett, f"make_{family}_service")(
            _shard(ctx, axis, family, model, None), **kw)
    if dist.get_rank() != 0:
        return svc.batches
    try:
        return [svc.predict(d, c, timeout=60) for d, c in requests]
    finally:
        svc.stop()


def tt_retrieve(ctx, axis, cfg, arrays, dense, q_cat, k):
    """The sharded retriever over the block-row index: every rank's
    `(scores, ids)` and its index block."""
    from embeddingtables_tpu_torch import parallel as P
    model = _family_model("two_tower", cfg, arrays)
    index = P.build_sharded_item_index(model, ctx.mesh(axis), axis)
    scores, ids = P.sharded_retrieve(model, index, ctx.mesh(axis),
                                     _t(dense), _t(q_cat), k=k, axis=axis)
    return _np(scores), ids.numpy(), _np(index)


# ---------------------------------------------------------------------------
# Sharded persistence and eviction
# ---------------------------------------------------------------------------

def family_evict(ctx, axis, family, cfg, arrays, opt, rows):
    """`evict_rows_sharded` of global `rows` from every stack of the
    sharded model: the unsharded model after."""
    from embeddingtables_tpu_torch.utils import evict_rows_sharded
    sm = _shard(ctx, axis, family, _family_model(family, cfg, arrays), opt)
    evict_rows_sharded(sm.tables, sm.emb_state, rows)
    if getattr(sm, "fm_w", None) is not None:
        evict_rows_sharded(sm.fm_w, sm.fm_state, rows)
    return model_out(_sharded_api(family)[3](sm))


def family_restore(ctx, axis, family, cfg, arrays, opt, delta_dir):
    """`restore_delta` of the chain(s) in `delta_dir` into the sharded
    model built from `arrays`: the unsharded model after."""
    from embeddingtables_tpu_torch.models.train import restore_delta
    from embeddingtables_tpu_torch.utils import DeltaCheckpointManager
    sm = _shard(ctx, axis, family, _family_model(family, cfg, arrays), opt)
    mgrs = (tuple(DeltaCheckpointManager(d) for d in delta_dir)
            if isinstance(delta_dir, (list, tuple))
            else DeltaCheckpointManager(delta_dir))
    restore_delta(mgrs, sm)
    return model_out(_sharded_api(family)[3](sm))


def family_ckpt(ctx, axis, family, cfg, arrays, other, opt, path):
    """A full checkpoint of the sharded model from `arrays`, restored into
    the one from `other` (the same placement): both unsharded."""
    from embeddingtables_tpu_torch.utils import CheckpointManager
    sm = _shard(ctx, axis, family, _family_model(family, cfg, arrays), opt)
    sm2 = _shard(ctx, axis, family, _family_model(family, cfg, other), opt)
    mgr = CheckpointManager(path)
    mgr.save(3, sm)
    mgr.restore_latest(sm2)
    unshard = _sharded_api(family)[3]
    return model_out(unshard(sm)), model_out(unshard(sm2)), \
        sorted(os.listdir(os.path.join(path, "3")))


def guard_agree(ctx, losses):
    """Each rank's `DivergenceGuard` reads `losses[rank]` through the mesh
    loop's agreement: what each guard read and whether it rolled back."""
    import torch
    from embeddingtables_tpu_torch.models.train import _mesh_agree
    from embeddingtables_tpu_torch.parallel.sharded import Exchange
    from embeddingtables_tpu_torch.utils import DivergenceGuard
    guard = DivergenceGuard(None)
    agree = _mesh_agree(guard, Exchange(ctx.mesh1, "data"),
                        torch.device("cpu"))
    seen = agree(losses[ctx.rank])
    _, rolled = guard.observe(seen, None)
    return seen, rolled


# ---------------------------------------------------------------------------
# JAX's public names over the port's functions (fault F3)
# ---------------------------------------------------------------------------

def f3_gather_apply(ctx, table, shifted, delta, opt, name):
    """`sharded_adam_apply` / `sharded_ftrl_apply` (JAX's table-major
    arguments, this rank's batch block) from the optimizer's fresh state:
    the unsharded table and state."""
    from embeddingtables_tpu_torch import parallel as P
    from embeddingtables_tpu_torch.parallel import sharded as S
    mesh = ctx.mesh1
    st = _st(ctx, "data", table)
    idx = _t(_block(ctx, "data", shifted, 1))
    dlt = _t(_block(ctx, "data", delta, 1))
    if name == "adam":
        m, v, count = S.init_sharded_adam_state(mesh, st)
        _, m, v, count = S.sharded_adam_apply(mesh, st, m, v, count, idx,
                                              dlt, opt)
        state = S.unshard_adam_state(st, m, v, count)
    else:
        z, n = S.init_sharded_ftrl_state(mesh, st, opt)
        _, z, n = S.sharded_ftrl_apply(mesh, st, z, n, idx, dlt, opt)
        state = P.unshard_row_state(st, type(S.init_sharded_ftrl_state(
            mesh, st, opt))(z=z, n=n))
    return _np(st.unshard()), [_np(s) for s in state]


def f3_a2a(ctx, table, upd, opt, name):
    """`sharded_<name>_update_a2a` of this rank's block at a capacity of n
    (nothing dropped): the unsharded table and state, and the overflow."""
    from embeddingtables_tpu_torch.ops.sparse_update import \
        SparseEmbeddingUpdate
    from embeddingtables_tpu_torch.parallel import alltoall as A
    from embeddingtables_tpu_torch.parallel import sharded as S
    mesh = ctx.mesh1
    st = _st(ctx, "data", table)
    u = SparseEmbeddingUpdate(delta=_t(_block(ctx, "data", upd["delta"])),
                              indices=_t(_block(ctx, "data",
                                                upd["indices"])))
    cf = float(ctx.n)
    if name == "sgd":
        _, ovf = A.sharded_sgd_update_a2a(mesh, st, u, opt.lr,
                                          capacity_factor=cf)
        state = []
    elif name == "adagrad":
        acc = S.init_sharded_row_state(mesh, st, opt).accum
        _, acc, ovf = A.sharded_adagrad_update_a2a(mesh, st, acc, u, opt,
                                                   capacity_factor=cf)
        state = [S.unshard_row_state(st, type(opt.init(st.data))(
            accum=acc)).accum]
    elif name == "adam":
        m, v, count = S.init_sharded_adam_state(mesh, st)
        _, m, v, count, ovf = A.sharded_adam_update_a2a(
            mesh, st, m, v, count, u, opt, capacity_factor=cf)
        state = list(S.unshard_adam_state(st, m, v, count))
    else:
        z, n = S.init_sharded_ftrl_state(mesh, st, opt)
        _, z, n, ovf = A.sharded_ftrl_update_a2a(mesh, st, z, n, u, opt,
                                                 capacity_factor=cf)
        state = list(S.unshard_row_state(st, type(
            S.init_sharded_ftrl_state(mesh, st, opt))(z=z, n=n)))
    return _np(st.unshard()), [_np(s) for s in state], int(ovf)


def f3_meshes(ctx, dense, cat):
    """`default_mesh(devices=...)` over every rank, `batch_shardings`
    against `local_batch`, and `shard_table`'s shard."""
    from embeddingtables_tpu_torch import parallel as P
    mesh = P.default_mesh(("data",), devices=list(range(ctx.n)),
                          device="cpu")
    sd, sc, sl = P.batch_shardings(mesh, "data")
    d, c = P.local_batch(mesh, "data", dense, cat)
    st = P.shard_table(mesh, "data", _t(dense))
    return (mesh.mesh.tolist(), np.array_equal(sd(dense), d),
            np.array_equal(sc(cat), c), _np(st.data))


def families_where_they_lie(ctx):
    """With no card visible: every family's sharded model made from a
    model on the CPU, one step, its eval and its mesh service (the
    retrieval service for the two-tower model), each on the CPU. Returns
    the device types of every result."""
    import torch
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch import parallel as P
    torch.cuda.is_available = lambda: False
    mesh = ctx.mesh1
    cfgs = {"dlrm": ett.DLRMConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                                   bottom_mlp=(4,), top_mlp=(3, 1)),
            "dcn": ett.DCNConfig(vocab_sizes=(5, 6), num_dense=2, dim=4,
                                 deep_mlp=(3,), cross_rank=2),
            "deepfm": ett.DeepFMConfig(vocab_sizes=(5, 6), num_dense=2,
                                       dim=4, deep_mlp=(3,), fold_fm_w=False)}
    dense, cat = torch.zeros(4, 2), torch.zeros(2, 4, dtype=torch.int32)
    label = torch.ones(4)
    seen = []
    for family, cfg in cfgs.items():
        model = getattr(ett, f"init_{family}")(cfg, device="cpu")
        shard, make_step, make_eval, _ = _sharded_api(family)
        sm = shard(model, mesh, "data")
        seen.append(make_step(cfg, mesh, "data")(sm, dense, cat,
                                                 label).device.type)
        seen.append(make_eval(cfg, mesh, "data")(sm, dense, cat).device.type)
        svc = getattr(ett, f"make_{family}_service")(sm, mesh=mesh)
        try:
            seen.append(type(svc.predict(dense.numpy(), cat.numpy(),
                                         timeout=30)).__module__)
        finally:
            svc.stop()
    tt = ett.TwoTowerConfig(query_vocab_sizes=(5, 6), item_vocab=7,
                            num_dense=2, dim=4, embed_dim=4,
                            query_mlp=(8, 4), item_mlp=(8, 4))
    model = ett.init_two_tower(tt, device="cpu")
    sm = P.shard_two_tower(model, mesh, "data")
    loss, acc = P.make_sharded_tt_train_step(tt, mesh)(
        sm, dense, cat, torch.arange(4))
    seen += [loss.device.type, acc.device.type,
             P.build_sharded_item_index(model, mesh).device.type]
    svc = ett.make_retrieval_service(model, k=2, mesh=mesh)
    try:
        seen.append(type(svc.predict(dense.numpy(), cat.numpy(),
                                     timeout=30)[1]).__module__)
    finally:
        svc.stop()
    return seen


# ---------------------------------------------------------------------------
# Column sharding and the planner
# ---------------------------------------------------------------------------

def _ct(ctx, table):
    from embeddingtables_tpu_torch.ops.ensemble import StackedTables
    from embeddingtables_tpu_torch.parallel import ColShardedStackedTables
    if isinstance(table, tuple):                   # (data, offsets)
        data, offsets = table
        table = StackedTables(_t(data), offsets, data.shape[1])
    elif isinstance(table, list):
        table = [_t(t) for t in table]
    else:
        table = _t(table)
    return ColShardedStackedTables.shard(ctx.mesh1, "data", table)


def col_layout(ctx, table):
    """This rank's slice, the unsharded table and each member table."""
    ct = _ct(ctx, table)
    return {"slice": _np(ct.data), "full": _np(ct.unshard()),
            "tables": [_np(ct.table(t)) for t in range(ct.ntables)]}


def col_lookup(ctx, table, idx, kw, batch_sharded=True):
    """`col_sharded_lookup` of this rank's block of `idx` (of the whole
    `idx` when not `batch_sharded`): this rank's rows."""
    from embeddingtables_tpu_torch.parallel import col_sharded_lookup
    ct = _ct(ctx, table)
    kw = dict(kw)
    if batch_sharded:
        if kw.get("weights") is not None:
            kw["weights"] = _t(_block(ctx, "data", kw["weights"]))
        idx = _block(ctx, "data", idx)
    elif kw.get("weights") is not None:
        kw["weights"] = _t(kw["weights"])
    return _np(col_sharded_lookup(ctx.mesh1, ct, _t(idx),
                                  batch_sharded=batch_sharded, **kw))


def _col_state_out(ct, state):
    """A col group's state as whole arrays: AdaGrad's accumulator as it is,
    Adam's and FTRL's slices unsliced to `(V, dim)`, Adam's count."""
    import torch
    from embeddingtables_tpu_torch.parallel.colshard import col_unslice
    if state is None:
        return []
    if torch.is_tensor(state):
        return [_np(state).copy()]
    return [_np(col_unslice(ct.exchange.gather_flat(x), ct.dim))
            if x.dim() == 2 else _np(x).copy() for x in state]


def col_update(ctx, table, upds, opt, sr_seed=None, bf16=False):
    """`col_sharded_update` of this rank's block of each update of `upds`
    (`dict(delta=, indices=, weights=)`), from `init_col_row_state`: the
    unsharded table and state after each step. `sr_seed`: each rank's
    generator seeded with `sr_seed + rank`; `bf16`: a bfloat16 table."""
    import torch
    from embeddingtables_tpu_torch.ops.sparse_update import \
        SparseEmbeddingUpdate
    from embeddingtables_tpu_torch.parallel import (col_sharded_update,
                                                    init_col_row_state)
    from embeddingtables_tpu_torch.optim import SparseSGD
    ct = _ct(ctx, table)
    if bf16:
        ct.data = ct.data.to(torch.bfloat16)
    state = init_col_row_state(ctx.mesh1, ct, opt)
    kw = {}
    if sr_seed is not None:
        kw["generator"] = torch.Generator().manual_seed(sr_seed + ctx.rank)
    out = []
    for u in upds:
        upd = SparseEmbeddingUpdate(
            delta=_t(_block(ctx, "data", u["delta"])),
            indices=_t(_block(ctx, "data", u["indices"])),
            weights=None if u.get("weights") is None
            else _t(_block(ctx, "data", u["weights"])))
        if isinstance(opt, SparseSGD):
            col_sharded_update(ctx.mesh1, ct, upd, opt, **kw)
        else:
            _, state = col_sharded_update(ctx.mesh1, ct, upd, opt, state,
                                          **kw)
        out.append({"table": _np(ct.unshard()),
                    "state": _col_state_out(ct, state)})
    return out


def col_guards(ctx, table):
    """The errors `col_sharded_update` raises before any exchange."""
    from embeddingtables_tpu_torch.ops.sparse_update import \
        SparseEmbeddingUpdate
    from embeddingtables_tpu_torch.optim import (SparseFTRL,
                                                 SparseRowWiseAdaGrad,
                                                 SparseSGD)
    from embeddingtables_tpu_torch.parallel import (col_sharded_lookup,
                                                    col_sharded_update)
    import torch
    ct = _ct(ctx, table)
    upd = SparseEmbeddingUpdate(delta=torch.zeros(2, ct.dim),
                                indices=torch.zeros(2, dtype=torch.int32))
    calls = [
        lambda: col_sharded_update(ctx.mesh1, ct, upd, SparseSGD(
            stochastic_rounding=True)),
        lambda: col_sharded_update(ctx.mesh1, ct, upd, SparseSGD(),
                                   torch.zeros(3)),
        lambda: col_sharded_update(ctx.mesh1, ct, upd,
                                   SparseRowWiseAdaGrad()),
        lambda: col_sharded_update(ctx.mesh1, ct, upd, SparseFTRL(),
                                   (torch.zeros(1), torch.zeros(1)), lr=0.5),
        lambda: col_sharded_update(ctx.mesh1, ct, upd, object()),
        lambda: col_sharded_lookup(ctx.mesh1, ct, torch.zeros(
            (2, 3), dtype=torch.int32), reducing=False, combiner="mean"),
    ]
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except Exception as e:  # noqa: BLE001
            out.append(type(e).__name__)
    return out


def _plan_of(ctx, axis, vocabs, dim, plan_kw):
    from embeddingtables_tpu_torch.parallel import plan_sharding
    return plan_sharding(list(vocabs), dim, ctx.mesh(axis), axis,
                         **(plan_kw or {}))


def planned_dense(pt):
    """A `PlannedTables` as one single-device model's would be: the stacked
    table in the plan's table order, the row state's vocab-leading leaves
    stacked the same way, and the groups' Adam counts (collectives)."""
    import torch
    from embeddingtables_tpu_torch.parallel.colshard import col_unslice
    from embeddingtables_tpu_torch.parallel.sharded import unshard_row_state
    per = [[] for _ in range(pt.ntables)]
    counts = []

    def split(leaves, table_ids, offs):
        for j, t in enumerate(table_ids):
            per[t] = [x[offs[j]:offs[j + 1]] for x in leaves]

    def leaves(state, v):
        out = []
        for x in state:
            if x.dim() == 0:
                counts.append(int(x))
            elif x.shape[0] == v and v:
                out.append(x)
        return out

    if pt.repl_tables:
        split(leaves(pt.repl_state, pt.repl.shape[0]), pt.repl_tables,
              pt.repl_offsets)
    if pt.shard_tables:
        st = pt.shard_state
        full = (unshard_row_state(pt.shard, st) if st[0].numel() else st)
        split(leaves(full, pt.shard.vocab), pt.shard_tables,
              pt.shard.offsets)
    if pt.col_tables:
        ct = pt.col
        full = [col_unslice(ct.exchange.gather_flat(x), ct.dim)
                if x.dim() == 2 else x for x in pt.col_state]
        split(leaves(full, ct.vocab), pt.col_tables, ct.offsets)
    nleaves = len(per[0])
    state = [_np(torch.cat([per[t][i] for t in range(pt.ntables)]))
             for i in range(nleaves)]
    return {"tables": _np(torch.cat(pt.tables())), "state": state,
            "counts": counts}


def _repl_bits(pt):
    """The replicated group's table and state as raw bytes."""
    return [_np(pt.repl).tobytes()] + [
        x.detach().cpu().numpy().tobytes() for x in pt.repl_state]


def planner_plans(ctx, axis, cases):
    """`plan_sharding(vocabs, dim, mesh, axis, **kw)` of each case on the
    rank's real mesh: each plan's fields."""
    import dataclasses
    out = []
    for vocabs, dim, kw in cases:
        p = _plan_of(ctx, axis, vocabs, dim, kw)
        out.append([dataclasses.asdict(d) for d in p.decisions]
                   + [p.n_devices, p.opt_state_bytes_per_device,
                      p.summary()])
    return out


def planner_ops(ctx, axis, vocabs, dim, plan_kw, tables, accums, opt, steps,
                kw, sr_seed=None, bf16=False):
    """`PlannedTables.from_tables` (then `planned_row_state` for `opt`),
    and for each `(cat, delta_t)` global step: `planned_lookup` of this
    rank's block (gathered over the data axis) and `planned_apply`. The
    lookups, the dense planned tables and state after each step, and the
    replicated group's bytes after each step. `bf16`: the tables stored
    as bfloat16."""
    import torch
    from embeddingtables_tpu_torch.parallel import (PlannedTables,
                                                    planned_apply,
                                                    planned_lookup,
                                                    planned_row_state)
    mesh = ctx.mesh(axis)
    plan = _plan_of(ctx, axis, vocabs, dim, plan_kw)
    pt = PlannedTables.from_tables(plan, mesh, [
        _t(t).to(torch.bfloat16 if bf16 else torch.float32) for t in tables],
                                   accums=None if accums is None
                                   else [_t(a) for a in accums])
    if accums is None:
        pt.set_row_state(*planned_row_state(mesh, pt, opt))
    ex = pt.exchange
    gen = (None if sr_seed is None
           else torch.Generator().manual_seed(sr_seed + ctx.rank))
    out = []
    for cat, delta_t in steps:
        c = _t(_block(ctx, axis, cat, 1))
        e = planned_lookup(mesh, pt, c, **kw)
        got = ex.gather_batch(e.transpose(0, 1).contiguous()).transpose(0, 1)
        planned_apply(mesh, pt, c, _t(_block(ctx, axis, delta_t, 1)), opt,
                      generator=gen, **kw)
        out.append({"lookup": _np(got), **planned_dense(pt),
                    "bits": _repl_bits(pt)})
    return out


def planned_evict(ctx, vocabs, dim, plan_kw, tables, opt, cold, state=None):
    """`evict_rows_planned` of per-table `cold` rows from the tables placed
    with `opt`'s state (carried from a single-device `state`, a list of
    stacked leaves, when given): the dense planned tables and state."""
    from embeddingtables_tpu_torch.ops.ensemble import StackedTables
    from embeddingtables_tpu_torch.parallel import (evict_rows_planned,
                                                    place_stacked_on_plan)
    plan = _plan_of(ctx, "data", vocabs, dim, plan_kw)
    st = StackedTables.stack([_t(t) for t in tables])
    emb = None
    if state is not None:
        import torch
        emb = type(opt.init(st.data))(*[torch.as_tensor(x) for x in state])
    pt = place_stacked_on_plan(plan, ctx.mesh1, st, emb, opt)
    evict_rows_planned(pt, cold)
    return planned_dense(pt)


def _planned_api(family):
    from embeddingtables_tpu_torch import parallel as P
    return {"dlrm": (P.make_planned_train_step, P.make_planned_eval_step),
            "dcn": (P.make_planned_dcn_train_step,
                    P.make_planned_dcn_eval_step),
            "deepfm": (P.make_planned_deepfm_train_step,
                       P.make_planned_deepfm_eval_step)}[family]


def _planned_model(ctx, axis, family, cfg, arrays, opt, plan_kw):
    from embeddingtables_tpu_torch.parallel import plan_model
    model = _family_model(family, cfg, arrays)
    plan = _plan_of(ctx, axis, cfg.vocab_sizes, model.tables.dim, plan_kw)
    return plan_model(model, plan, ctx.mesh(axis), opt)


def planned_family_steps(ctx, axis, family, cfg, arrays, opt, plan_kw,
                         batches, step_kw=None):
    """The family's planned step on each global batch, each rank on its
    block: the losses, the dense planned model, the replicated group's
    bytes after each step, and the eval of the last batch."""
    from embeddingtables_tpu_torch.parallel import local_batch
    from embeddingtables_tpu_torch.parallel.dlrm import sharded_logits
    mesh = ctx.mesh(axis)
    pm = _planned_model(ctx, axis, family, cfg, arrays, opt, plan_kw)
    make_step, make_eval = _planned_api(family)
    step = make_step(cfg, mesh, sparse_opt=opt, dense_lr=0.1,
                     **(step_kw or {}))
    losses, bits = [], []
    for dense, cat, label in batches:
        d, c, l = local_batch(mesh, axis, _t(dense), _t(cat), _t(label))
        losses.append(float(step(pm, d, c, l)))
        bits.append(_repl_bits(pm.tables))
    logits = None
    if batches:
        dense, cat, _ = batches[-1]
        logits = _np(sharded_logits(pm, _t(dense), _t(cat),
                                    make_eval(cfg, mesh)))
    return {"losses": losses, "bits": bits, "logits": logits,
            "towers": [_np(p) for _, p in pm.tower_params()],
            **planned_dense(pm.tables)}


def planned_loop(ctx, family, cfg, arrays, opt, plan_kw, batches, kw):
    """`train_<family>(mesh=, plan=)` over the global batches from the
    single-device weights `arrays`, with `kw` (`ckpt_dir` makes a
    `CheckpointManager` there, `guard=True` a `DivergenceGuard` on it):
    losses, AUCs, evicted rows, rollbacks and the dense planned model."""
    from embeddingtables_tpu_torch.models import train as T
    from embeddingtables_tpu_torch.utils import (CheckpointManager,
                                                 DivergenceGuard)
    kw = dict(kw)
    guard = None
    if kw.get("ckpt_dir") is not None:
        kw["ckpt_manager"] = CheckpointManager(kw.pop("ckpt_dir"))
        if kw.pop("guard", False):
            guard = kw["guard"] = DivergenceGuard(kw["ckpt_manager"])
    plan = _plan_of(ctx, "data", cfg.vocab_sizes,
                    arrays["table_data"].shape[1], plan_kw)
    res = getattr(T, f"train_{family}")(
        cfg, iter([dict(zip(("dense", "cat", "label"), b)) for b in batches]),
        len(batches), model=dict(arrays), mesh=ctx.mesh1, plan=plan,
        sparse_opt=opt, device="cpu", verbose=False, **kw)
    return {"losses": res.losses, "evals": res.aucs,
            "evicted": res.evicted_rows,
            "rollbacks": None if guard is None else guard.rollbacks,
            "type": type(res.model).__name__,
            "towers": [_np(p) for _, p in res.model.tower_params()],
            **planned_dense(res.model.tables)}


def planned_serve(ctx, family, cfg, arrays, plan_kw, requests):
    """`make_<family>_service(mesh=)` of the planned model: rank 0 answers
    `requests` and stops; the other ranks follow until then."""
    import torch.distributed as dist
    import embeddingtables_tpu_torch as ett
    pm = _planned_model(ctx, "data", family, cfg, arrays, None, plan_kw)
    svc = getattr(ett, f"make_{family}_service")(
        pm, mesh=ctx.mesh1, max_batch=16, max_latency_ms=2.0)
    if dist.get_rank() != 0:
        return svc.batches
    try:
        return [svc.predict(d, c, timeout=60) for d, c in requests]
    finally:
        svc.stop()


def planned_misc(ctx, cfgs, arrays):
    """What the planned families refuse: a foreign model and an unfolded
    DeepFM under `plan=`, a planned DeepFM's mesh service, a plan whose dim
    is not the fused stack's; and a single-device model carried onto a plan
    whose placement is its own (the names of the exceptions)."""
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch.models.train import train_dlrm
    from embeddingtables_tpu_torch.parallel import (init_planned_deepfm,
                                                    plan_model)
    mesh = ctx.mesh1
    dcfg, fcfg, ucfg = cfgs
    plan = _plan_of(ctx, "data", dcfg.vocab_sizes, dcfg.dim,
                    dict(col_shard=[1]))
    out = []
    calls = [
        lambda: train_dlrm(dcfg, iter(()), 1, mesh=mesh, plan=plan,
                           model=object(), verbose=False, device="cpu"),
        lambda: plan_model(ett.init_deepfm(ucfg, device="cpu"), plan, mesh),
        lambda: init_planned_deepfm(fcfg, plan, mesh),
        lambda: ett.make_deepfm_service(init_planned_deepfm(
            fcfg, _plan_of(ctx, "data", fcfg.vocab_sizes, fcfg.stack_dim,
                           dict(col_shard=[1])), mesh), mesh=mesh),
    ]
    for call in calls:
        try:
            call()
            out.append(None)
        except Exception as e:  # noqa: BLE001
            out.append(f"{type(e).__name__}: {e}")
    return out


def planned_where_they_lie(ctx):
    """With no card visible: a planned DLRM and DCN on a one-rank group
    under a hand-made three-way plan (one rank's `plan_sharding`
    replicates everything), one step, the eval and the mesh service: the
    device types of every result."""
    import dataclasses
    import torch
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch import parallel as P
    torch.cuda.is_available = lambda: False
    mesh = ctx.mesh1
    cfgs = {"dlrm": ett.DLRMConfig(vocab_sizes=(5, 6, 7), num_dense=2, dim=4,
                                   bottom_mlp=(4,), top_mlp=(3, 1)),
            "dcn": ett.DCNConfig(vocab_sizes=(5, 6, 7), num_dense=2, dim=4,
                                 deep_mlp=(3,), cross_rank=2)}
    plan = P.plan_sharding((5, 6, 7), 4, mesh)
    plan = dataclasses.replace(plan, decisions=tuple(
        dataclasses.replace(d, placement=p) for d, p in zip(
            plan.decisions, (P.REPLICATE, P.ROW_SHARD, P.COL_SHARD))))
    dense, cat = torch.zeros(4, 2), torch.zeros(3, 4, dtype=torch.int32)
    seen = []
    for family, cfg in cfgs.items():
        init = getattr(P, f"init_planned_{family}")
        make_step, make_eval = _planned_api(family)
        pm = init(cfg, plan, mesh, sparse_opt=ett.SparseRowWiseAdaGrad())
        seen.append(pm.tables.device.type)
        seen.append(make_step(cfg, mesh)(pm, dense, cat,
                                         torch.ones(4)).device.type)
        seen.append(make_eval(cfg, mesh)(pm, dense, cat).device.type)
        svc = getattr(ett, f"make_{family}_service")(pm, mesh=mesh)
        try:
            seen.append(type(svc.predict(dense.numpy(), cat.numpy(),
                                         timeout=30)).__module__)
        finally:
            svc.stop()
    return seen


# ---------------------------------------------------------------------------
# Mixed dims, the planned two-tower model and the CLIs (test_torch_planner_tt)
# ---------------------------------------------------------------------------

def _by_hand(plan, places):
    """`plan` with the given placements (one rank's `plan_sharding`
    replicates every table)."""
    import dataclasses
    return dataclasses.replace(plan, decisions=tuple(
        dataclasses.replace(d, placement=p)
        for d, p in zip(plan.decisions, places)))


def mixed_ops(ctx, vocabs, dims, plan_kw, tables, opt, steps, init_seed=None,
              sr_seed=None, bf16=False):
    """`plan_sharding_mixed` on the rank's mesh, `MixedDimPlannedTables`
    from `tables` (or by `init` from `init_seed`) with `opt`'s state, then
    for each `(idx, deltas)` global step this rank's block through
    `mixed_planned_lookup` (gathered over the data axis) and
    `mixed_planned_apply`. The groups, placements, initial tables, lookups
    and the dense groups after each step."""
    import torch
    from embeddingtables_tpu_torch.parallel import (MixedDimPlannedTables,
                                                    mixed_planned_apply,
                                                    mixed_planned_lookup,
                                                    plan_sharding_mixed)
    mesh = ctx.mesh1
    plans, groups = plan_sharding_mixed(list(vocabs), list(dims), mesh,
                                        **(plan_kw or {}))
    if init_seed is not None:
        mt = MixedDimPlannedTables.init(
            torch.Generator().manual_seed(init_seed), plans, groups, mesh,
            sparse_opt=opt)
    else:
        mt = MixedDimPlannedTables.from_tables(
            plans, groups, mesh,
            [_t(t).to(torch.bfloat16 if bf16 else torch.float32)
             for t in tables], sparse_opt=opt)
    ex = mt.groups[0].exchange
    gen = (None if sr_seed is None
           else torch.Generator().manual_seed(sr_seed + ctx.rank))
    out = {"groups": [list(g) for g in groups],
           "placements": [[d.placement for d in p.decisions] for p in plans],
           "init": [_np(mt.table(t)).copy() for t in range(mt.ntables)],
           "steps": []}
    for idx, deltas in steps:
        block = [_t(_block(ctx, "data", i)) for i in idx]
        got = mixed_planned_lookup(mesh, mt, block)
        mixed_planned_apply(mesh, mt, block,
                            [_t(_block(ctx, "data", d)) for d in deltas],
                            opt, generator=gen)
        out["steps"].append({
            "lookup": [_np(ex.gather_batch(g.contiguous())) for g in got],
            "groups": [planned_dense(pt) for pt in mt.groups],
            "bits": [_repl_bits(pt) for pt in mt.groups]})
    return out


def mixed_sr_order(ctx, vocabs, dims, tables, seed):
    """Stochastic rounding on bf16 mixed-dim tables: `mixed_planned_apply`
    with a generator against each group's `planned_apply` in group order
    with a generator of the same seed (the groups draw one after the
    other). Whether the two give the same bits."""
    import torch
    from embeddingtables_tpu_torch.parallel import (MixedDimPlannedTables,
                                                    mixed_planned_apply,
                                                    plan_sharding_mixed,
                                                    planned_apply)
    from embeddingtables_tpu_torch.optim import SparseSGD
    mesh = ctx.mesh1
    plans, groups = plan_sharding_mixed(list(vocabs), list(dims), mesh,
                                        replicate_max_bytes=1 << 20)
    opt = SparseSGD(0.3, stochastic_rounding=True)
    rng = np.random.default_rng(seed)
    idx = [_t(rng.integers(0, v, 8).astype(np.int32)) for v in vocabs]
    deltas = [_t(rng.standard_normal((8, d)).astype(np.float32) * 1e-3)
              for d in dims]

    def fresh():
        return MixedDimPlannedTables.from_tables(
            plans, groups, mesh, [_t(t).to(torch.bfloat16) for t in tables])
    a, b = fresh(), fresh()
    mixed_planned_apply(mesh, a, idx, deltas, opt,
                        generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed)
    for g, pt in enumerate(b.groups):
        ts = b.members(g)
        planned_apply(mesh, pt, [idx[t] for t in ts],
                      torch.stack([deltas[t] for t in ts]), opt,
                      generator=gen)
    same = all(torch.equal(a.table(t).view(torch.int16),
                           b.table(t).view(torch.int16))
               for t in range(a.ntables))
    moved = any(not torch.equal(a.table(t).float(), _t(tables[t]).to(
        torch.bfloat16).float()) for t in range(a.ntables))
    return same, moved


def _tt_plans(ctx, cfg, q_kw, i_kw, places=None):
    from embeddingtables_tpu_torch.parallel import plan_sharding
    mesh = ctx.mesh1
    qp = plan_sharding(cfg.query_vocab_sizes, cfg.dim, mesh, **q_kw)
    ip = plan_sharding([cfg.item_vocab], cfg.dim, mesh, **i_kw)
    if places is not None:
        qp, ip = _by_hand(qp, places[0]), _by_hand(ip, places[1])
    return qp, ip


def _planned_tt_out(pm):
    return {"query": planned_dense(pm.query_tables),
            "items": planned_dense(pm.item_tables),
            "towers": [_np(p) for p in pm.parameters()],
            "bits": _repl_bits(pm.query_tables)}


def planned_tt_steps(ctx, cfg, arrays, opt, q_kw, i_kw, batches,
                     places=None):
    """`place_two_tower_on_plan` of the single-device weights `arrays`,
    then `make_planned_tt_train_step` on each global batch, each rank on
    its block: losses, accuracies, the dense planned model and the
    replicated group's bytes. `places`: the plans' placements by hand."""
    from embeddingtables_tpu_torch.interop import two_tower_from_arrays
    from embeddingtables_tpu_torch.parallel import (
        make_planned_tt_train_step, place_two_tower_on_plan,
        tt_batch_shardings)
    mesh = ctx.mesh1
    qp, ip = _tt_plans(ctx, cfg, q_kw, i_kw, places)
    pm = place_two_tower_on_plan(
        qp, ip, mesh, two_tower_from_arrays(cfg, device="cpu", **arrays), opt)
    step = make_planned_tt_train_step(cfg, mesh, sparse_opt=opt, dense_lr=0.1)
    put = tt_batch_shardings(mesh)
    losses, accs = [], []
    for batch in batches:
        loss, acc = step(pm, *(_t(f(x)) for f, x in zip(put, batch)))
        losses.append(float(loss))
        accs.append(float(acc))
    return {"losses": losses, "accs": accs, **_planned_tt_out(pm)}


def planned_tt_bitwise(ctx, cfg, arrays, opt, batches, places):
    """One rank: the planned two-tower step under the hand-made `places`
    against the single-device step from the same weights: the names of
    what differs in any bit (losses, query tables, items, towers)."""
    import torch
    from embeddingtables_tpu_torch.interop import two_tower_from_arrays
    from embeddingtables_tpu_torch.models.two_tower import make_train_step
    from embeddingtables_tpu_torch.parallel import (
        make_planned_tt_train_step, place_two_tower_on_plan)
    mesh = ctx.mesh1
    qp, ip = _tt_plans(ctx, cfg, {}, {}, places)
    pm = place_two_tower_on_plan(
        qp, ip, mesh, two_tower_from_arrays(cfg, device="cpu", **arrays), opt)
    single = two_tower_from_arrays(cfg, device="cpu", **arrays)
    step = make_planned_tt_train_step(cfg, mesh, sparse_opt=opt, dense_lr=0.1)
    step1 = make_train_step(cfg, sparse_opt=opt, dense_lr=0.1)
    bad = []
    for s, batch in enumerate(batches):
        args = [_t(x) for x in batch]
        lp, ap = step(pm, *args)
        l1, a1 = step1(single, *args)
        if not (torch.equal(lp, l1) and torch.equal(ap, a1)):
            bad.append(f"loss {s}")
    if not torch.equal(torch.cat(pm.query_tables.tables()),
                       single.query_tables.data):
        bad.append("query tables")
    if not torch.equal(pm.item_tables.tables()[0], single.item_data):
        bad.append("items")
    if not all(torch.equal(a, b) for a, b in zip(pm.parameters(),
                                                   single.parameters())):
        bad.append("towers")
    for name, st in (("q", single.q_state), ("i", single.i_state)):
        pt = pm.query_tables if name == "q" else pm.item_tables
        got = planned_dense(pt)["state"]
        want = [_np(x) for x in st if x.dim() and x.numel()]
        if any(not np.array_equal(g, w) for g, w in zip(got, want)) or \
                len(got) != len(want):
            bad.append(f"{name} state")
    return bad


def planned_tt_serve(ctx, cfg, arrays, q_kw, i_kw, batch, dense, q_cat, k):
    """`planned_build_item_index` (chunks of `batch` items) and
    `planned_retrieve` of the planned model: the index and the top k."""
    from embeddingtables_tpu_torch.interop import two_tower_from_arrays
    from embeddingtables_tpu_torch.optim import SparseSGD
    from embeddingtables_tpu_torch.parallel import (place_two_tower_on_plan,
                                                    planned_build_item_index,
                                                    planned_retrieve)
    mesh = ctx.mesh1
    qp, ip = _tt_plans(ctx, cfg, q_kw, i_kw)
    pm = place_two_tower_on_plan(
        qp, ip, mesh, two_tower_from_arrays(cfg, device="cpu", **arrays),
        SparseSGD(0.1))
    index = planned_build_item_index(mesh, pm, batch=batch)
    scores, ids = planned_retrieve(mesh, pm, index, _t(dense), _t(q_cat), k=k)
    return _np(index), _np(scores), ids.numpy()


def planned_tt_loop(ctx, cfg, arrays, opt, q_kw, i_kw, batches, evals,
                    ckpt_dir):
    """`train_two_tower(mesh=, plan=)` from the single-device weights with
    a recall eval, `device_prefetch=1` and a `CheckpointManager` saving
    every 2 steps; then the last checkpoint restored into a fresh planned
    model of the same placement: the losses, recalls, the dense planned
    model, and whether the restore is bitwise the trained model."""
    import torch
    from embeddingtables_tpu_torch.models.train import train_two_tower
    from embeddingtables_tpu_torch.parallel import init_planned_two_tower
    from embeddingtables_tpu_torch.utils import CheckpointManager
    mesh = ctx.mesh1
    qp, ip = _tt_plans(ctx, cfg, q_kw, i_kw)
    keys = ("dense", "q_cat", "item_ids")
    mgr = CheckpointManager(ckpt_dir)
    res = train_two_tower(
        cfg, iter([dict(zip(keys, b)) for b in batches]), len(batches),
        model=dict(arrays), mesh=mesh, plan=(qp, ip), sparse_opt=opt,
        dense_lr=0.1, log_every=1, eval_every=2,
        eval_batches=[dict(zip(keys, b)) for b in evals], k=5,
        ckpt_manager=mgr, ckpt_every=2, device_prefetch=1, device="cpu",
        verbose=False)
    fresh = init_planned_two_tower(cfg, qp, ip, mesh, sparse_opt=opt, seed=7)
    mgr.restore_latest(fresh)
    same = all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), res.model.state_dict().values()))
    return {"losses": res.losses, "recalls": res.recalls,
            "type": type(res.model).__name__, "step": mgr.latest_step(),
            "restored_bitwise": same, **_planned_tt_out(res.model)}


def cli_mesh(ctx, argv):
    """A port CLI's `main(argv)` on every rank of the (already formed)
    group: the losses and the plan's placements."""
    from embeddingtables_tpu_torch.scripts import train_dlrm
    res = train_dlrm.main(argv)
    pt = res.model.tables
    return {"losses": res.losses, "type": type(res.model).__name__,
            "placements": [d.placement for d in pt.plan.decisions]}

"""The single-device training loops (counterpart of
`embeddingtables_tpu/models/train.py`): one loop behind four thin entry
points.

  - `_Family` names one CTR family's init, train-step and eval-step
    factories and its `*_from_arrays` builder; `_train_ctr` trains any of
    them on `dense`/`cat`/`label` batches. `train_dlrm`, `train_dcn` and
    `train_deepfm` are thin calls.
  - `_run_loop` owns the per-step cadence for every family, each part
    timed as a telemetry phase ("data", "step", "eval", "delta_ckpt",
    "checkpoint"; "init" when the loop builds the model): fetch a host
    batch and move it to the model's device, feed the frequency trackers,
    run the step (which updates the model in place), evict stale rows every
    `evict_every` steps, read the loss back at the log cadence and feed it
    to the divergence guard, evaluate at `eval_every`, save the touched rows
    every `delta_every` steps and a full checkpoint every `ckpt_every`.
    `train_two_tower` runs it with its own batches, step and recall@k eval.
  - `restore_delta` resumes any family's tables and sparse optimizer state
    from the delta chain a loop wrote, in place.

Every loop takes every parameter of its JAX counterpart. The CTR loops
read `dense_tx` (the towers' `torch.optim` factory; a fresh model is built
with its state) and `microbatch` (passed to the family's train step), and
every loop reads `device_prefetch`: the next batches are copied to the card
on a side stream while the current step runs (`io.loader.DevicePrefetcher`).
With `mesh=...` every loop trains its family's sharded model
(`parallel/{dlrm,dcn,deepfm,two_tower}.py`): every rank runs the loop on the
same global batch iterator and steps on its data-axis block. The loop's
options hold there too: full checkpoints are saved by every rank together
(one part each), the guard's verdict is reduced over the ranks so that all
of them roll back together, delta checkpoints go through the table's
`ModRowLayout`, and every rank evicts the same rows (`evict_rows_sharded`;
the trackers follow the same global batches). With `mesh=...` and
`plan=...` (a `parallel.planner.ShardingPlan`) the CTR loops train the
family's planned model (`parallel/planner.py`): replicated, row- and
column-sharded tables in one model, evicting through `evict_rows_planned`,
with checkpoints and the guard as on the mesh; delta checkpoints under a
plan raise JAX's `NotImplementedError`. `train_two_tower(mesh=,
plan=(q_plan, i_plan))` trains the planned two-tower model the same way.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..metrics import (auc, calibration, log_loss, normalized_entropy,
                       recall_at_k)
from ..optim import SparseFTRL, SparseSGD, require_dense_state
from ..unported import check_jax_combinations
from ..utils import telemetry as _telemetry
from ..utils.deltackpt import ModRowLayout, TouchedRowTracker
from ..utils.rowstats import (FrequencyTracker, evict_rows,
                              evict_rows_sharded, reset_rows_state)
from .dlrm import DLRMConfig


@dataclasses.dataclass
class TrainResult:
    model: object
    losses: list
    aucs: list            # [(step, auc)]
    examples_per_sec: float
    evicted_rows: int = 0


@dataclasses.dataclass
class RetrievalTrainResult:
    model: object
    losses: list
    accs: list               # in-batch top-1 accuracy at the log cadence
    recalls: list            # [(step, recall@k)]
    examples_per_sec: float


def _collect_scores(eval_step, model, batches):
    """One pass of `eval_step` over host `batches` -> (labels, logits)."""
    labels, scores = [], []
    for b in batches:
        labels.append(b["label"])
        scores.append(eval_step(model, b["dense"], b["cat"]).float().cpu()
                      .numpy())
    return np.concatenate(labels), np.concatenate(scores)


def evaluate_auc(eval_step, model, batches, *, to_device=None) -> float:
    """AUC of `eval_step`'s logits over host `batches`. `to_device` is
    JAX's batch placement and is ignored: the eval step moves its inputs to
    the model's device."""
    return auc(*_collect_scores(eval_step, model, batches))


def evaluate_metrics(eval_step, model, batches, *, to_device=None) -> dict:
    """The CTR eval sweep: AUC, log loss, normalized entropy and
    calibration of `eval_step`'s logits over host `batches` (`to_device` as
    in `evaluate_auc`)."""
    y, z = _collect_scores(eval_step, model, batches)
    return dict(auc=auc(y, z), log_loss=log_loss(y, z),
                normalized_entropy=normalized_entropy(y, z),
                calibration=calibration(y, z))


def _sr_generator_for(sparse_opt, seed: int, device: torch.device):
    """The stochastic-rounding generator when the optimizer rounds
    stochastically: seeded once from `seed`, advanced by every step, so each
    step draws fresh noise."""
    if getattr(sparse_opt, "stochastic_rounding", False):
        return torch.Generator(device=device).manual_seed(seed + 1_000_003)
    return None


def _check_schedule(sparse_opt, lr_schedule) -> None:
    """FTRL takes no `lr_schedule`: `ValueError` before the first step."""
    if lr_schedule is not None and isinstance(sparse_opt, SparseFTRL):
        raise ValueError(
            "SparseFTRL cannot change lr per step: alpha is baked into the "
            "accumulated z state, so it takes no lr_schedule")


def _ctr_eval_fn(eval_step, eval_batches, eval_metrics: bool):
    """The CTR loops' eval hook: AUC, or with `eval_metrics` the whole
    sweep, of `eval_step`'s logits over `eval_batches`."""
    def eval_fn(m):
        if eval_metrics:
            met = evaluate_metrics(eval_step, m, eval_batches)
            return met["auc"], (
                f"eval AUC {met['auc']:.4f}  logloss {met['log_loss']:.5f}  "
                f"NE {met['normalized_entropy']:.4f}  calib "
                f"{met['calibration']:.3f}")
        a = evaluate_auc(eval_step, m, eval_batches)
        return a, f"eval AUC {a:.4f}"
    return eval_fn


def _run_loop(*, model, device, step, put, train_iter, num_steps, tel,
              batch_count, lr_schedule=None, generator=None, track_fn=None,
              evict_every=0, evict_fn=None, split_out=None, log_every=100,
              verbose=True, on_log=None, guard=None, on_rollback=None,
              eval_every=0, eval_batches=None, eval_fn=None, delta_fn=None,
              ckpt_manager=None, ckpt_every=0, device_prefetch=0,
              tuner=None, tuner_occ_fn=None, rebuild_step=None,
              agree=None):
    """The shared per-step cadence. `device_prefetch > 0` runs `put` on
    the next batches beside the step (`io.loader.DevicePrefetcher`, that
    many batches ahead). With a `tuner` (`parallel.alltoall.
    CapacityAutoTuner`) the step returns `(loss, overflow)`: the tuner
    reads the overflow at the log cadence and the loop rebuilds the step at
    the factor it returns (`rebuild_step(factor)`). Hooks:

      put(batch) -> args              the step's positional inputs
      track_fn(batch)                 feed the frequency trackers
      evict_fn(model) -> n            at the evict_every cadence, in place
      split_out(out) -> loss          default: the output is the loss
      on_log(i, loss_value)           replaces the default log line
      on_rollback()                   the guard rolled the model back
      eval_fn(model) -> (value, line) at the eval_every cadence
      delta_fn(i, model, batch)       delta observe + cadence save
      agree(loss_value) -> value      what the guard reads (a mesh: NaN on
                                      every rank when any rank's guard
                                      would count the loss as bad)

    Returns (model, losses, evals, examples_per_sec, evicted_total): the
    model the guard returned last, which its in-place restore keeps the
    one the loop was given."""
    losses, evals = [], []
    examples = 0
    evicted_total = 0
    prefetcher = None
    if device_prefetch:
        from ..io.loader import DevicePrefetcher
        prefetcher = DevicePrefetcher(train_iter, put, depth=device_prefetch,
                                      device=device)
    t_start = time.perf_counter()
    for i in range(num_steps):
        with tel.phase("data"):
            if prefetcher is not None:
                batch, args = next(prefetcher)
            else:
                batch = next(train_iter)
                args = put(batch)
        if track_fn is not None:
            track_fn(batch)
        kw = {} if generator is None else {"generator": generator}
        if lr_schedule is not None:
            kw["lr"] = lr_schedule(i)
        with tel.phase("step"):
            out = step(model, *args, **kw)
        if evict_fn is not None and (i + 1) % evict_every == 0:
            # Only rows seen and then gone stale (never-seen rows sit at
            # their init values), each popped so it is not evicted again
            # unless it reappears.
            evicted_total += evict_fn(model)
        loss = out if split_out is None else split_out(out)
        examples += batch_count(batch)
        if tuner is not None and i == 0:
            tuner.occ = tuner_occ_fn(batch)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            lv = float(loss)       # waits for the step: keeps the rate honest
            losses.append(lv)
            if tuner is not None:
                # The overflow is summed over the ranks inside the step, so
                # every rank takes the same decision.
                new_cf = tuner.observe(int(out[1]))
                if new_cf is not None:
                    with tel.phase("retune"):
                        step = rebuild_step(new_cf)
                    if verbose:
                        print(f"step {i:6d}  overflow {int(out[1])} — "
                              f"capacity factor -> {new_cf:.2f} (step "
                              "rebuilt)", flush=True)
            if guard is not None:
                # The divergence watchdog reads the loss at the log cadence
                # (a read every step would wait for every step). A rollback
                # copies the last checkpoint into the model in place.
                model, rolled = guard.observe(
                    lv if agree is None else agree(lv), model)
                if rolled:
                    if on_rollback is not None:
                        on_rollback()
                    if verbose:
                        print(f"step {i:6d}  DIVERGED (loss {lv:.3g}) — "
                              f"rolled back to checkpoint", flush=True)
            if on_log is not None:
                on_log(i, lv)
            elif verbose:
                print(f"step {i:6d}  loss {lv:.5f}", flush=True)
        if eval_every and eval_batches and (i + 1) % eval_every == 0:
            with tel.phase("eval"):
                value, line = eval_fn(model)
            evals.append((i + 1, value))
            if verbose:
                print(f"step {i + 1:6d}  {line}", flush=True)
        if delta_fn is not None:
            delta_fn(i, model, batch)
        if ckpt_manager is not None and ckpt_every and \
                (i + 1) % ckpt_every == 0:
            with tel.phase("checkpoint"):
                ckpt_manager.save(i + 1, model)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (model, losses, evals, examples / (time.perf_counter() - t_start),
            evicted_total)


# ---------------------------------------------------------------------------
# The CTR families and their loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Family:
    """One CTR family: its init, train-step and eval-step factories, its
    builder from numpy arrays (`model=` may be the builder's keyword
    arguments, a model trained by the JAX package), `sharded()`, its mesh
    placement: `(sharded model class, shard function, sharded train- and
    eval-step factories)`, and `planned()`, its planner placement:
    `(planned model class, planned init, planned train- and eval-step
    factories)`."""

    name: str
    init: Callable         # (cfg, generator, device=, sparse_opt=, dense_tx=)
    train_step: Callable   # (cfg, sparse_opt=, dense_lr=, dense_tx=,
                           #  microbatch=) -> step
    eval_step: Callable    # (cfg) -> step
    from_arrays: Callable  # (cfg, device=, **arrays) -> model
    sharded: Callable      # () -> (cls, shard, train step, eval step)
    planned: Callable      # () -> (cls, init, train step, eval step)


def _dlrm_family() -> _Family:
    from . import dlrm
    from ..interop import dlrm_from_arrays

    def sharded():
        from ..parallel import dlrm as p
        return (p.ShardedDLRM, p.shard_dlrm, p.make_sharded_train_step,
                p.make_sharded_eval_step)

    def planned():
        from ..parallel import planner as p
        return (p.PlannedDLRM, p.init_planned_dlrm, p.make_planned_train_step,
                p.make_planned_eval_step)
    return _Family("dlrm", dlrm.init_dlrm, dlrm.make_train_step,
                   dlrm.make_eval_step, dlrm_from_arrays, sharded, planned)


def _dcn_family() -> _Family:
    from . import dcn
    from ..interop import dcn_from_arrays

    def sharded():
        from ..parallel import dcn as p
        return (p.ShardedDCN, p.shard_dcn, p.make_sharded_dcn_train_step,
                p.make_sharded_dcn_eval_step)

    def planned():
        from ..parallel import planner as p
        return (p.PlannedDCN, p.init_planned_dcn,
                p.make_planned_dcn_train_step, p.make_planned_dcn_eval_step)
    return _Family("dcn", dcn.init_dcn, dcn.make_train_step,
                   dcn.make_eval_step, dcn_from_arrays, sharded, planned)


def _deepfm_family() -> _Family:
    from . import deepfm
    from ..interop import deepfm_from_arrays

    def sharded():
        from ..parallel import deepfm as p
        return (p.ShardedDeepFM, p.shard_deepfm,
                p.make_sharded_deepfm_train_step,
                p.make_sharded_deepfm_eval_step)

    def planned():
        from ..parallel import planner as p
        return (p.PlannedDeepFM, p.init_planned_deepfm,
                p.make_planned_deepfm_train_step,
                p.make_planned_deepfm_eval_step)
    return _Family("deepfm", deepfm.init_deepfm, deepfm.make_train_step,
                   deepfm.make_eval_step, deepfm_from_arrays, sharded, planned)


def _model_for(init, from_arrays, cfg, model, seed: int, device,
               sparse_opt, tel, **init_kw):
    """The model to train in place: `model` itself, one built from numpy
    arrays (`model` a dict of `from_arrays`'s keyword arguments), or a fresh
    `init` from `seed` on `device` (CUDA unless given), with `init_kw`
    (the CTR loops' `dense_tx`)."""
    if isinstance(model, dict):
        return from_arrays(cfg, device=resolve_device(device), **model)
    if model is not None:
        return model
    device = resolve_device(device)
    with tel.phase("init"):
        return init(cfg, torch.Generator(device=device).manual_seed(seed),
                    device=device, sparse_opt=sparse_opt, **init_kw)


def _layout(tables):
    """The delta checkpoints' row layout of `tables`: None (flat) on one
    device, the `ModRowLayout` of a sharded table."""
    return ModRowLayout.for_tables(tables) if hasattr(tables, "exchange") \
        else None


def _maybe_evict(model, trackers, evict_threshold: float, stacks,
                 delta_tracker=None) -> int:
    """Pop each tracker's stale rows and evict them from the model, in
    place: every stack of `stacks` (`(tables, state)` attribute names
    sharing the first stack's offsets) gets the rows zeroed and its
    optimizer state reset at them (on a mesh, on the rank that owns each
    row: `evict_rows_sharded`). DeepFM's unfolded layout passes its
    first-order stack too, so a stale row loses both representations and
    both states. Returns the number of rows evicted.

    `delta_tracker`: the delta checkpoint's `TouchedRowTracker`, when delta
    checkpoints are on. Eviction rewrites rows the input stream did not
    touch, so they are marked, or the next delta would leave them out and a
    restore would differ from the live model."""
    first = getattr(model, stacks[0][0])
    if hasattr(first, "repl_tables"):
        # A planned placement: per-table rows, each group evicts its own.
        from ..parallel.planner import evict_rows_planned
        cold_pt = [tr.pop_cold(evict_threshold) for tr in trackers]
        ncold = int(sum(c.size for c in cold_pt))
        if ncold:
            evict_rows_planned(first, cold_pt)
        return ncold
    cold = np.concatenate([tr.pop_cold(evict_threshold) + first.offsets[t]
                           for t, tr in enumerate(trackers)])
    if not cold.size:
        return 0
    if delta_tracker is not None:
        delta_tracker.observe(cold)
    rows = torch.from_numpy(cold.astype(np.int64)).to(first.data.device)
    for tables_attr, state_attr in stacks:
        tables = getattr(model, tables_attr)
        if hasattr(tables, "exchange"):
            evict_rows_sharded(tables, getattr(model, state_attr), rows)
        else:
            evict_rows(tables.data, rows)
            reset_rows_state(getattr(model, state_attr), rows)
    return int(cold.size)


def _evict_hooks(cfg, evict_every: int, evict_threshold: float,
                 freq_decay: float, evict_stacks=None, delta_tracker=None):
    """(track_fn, evict_fn) of the loop, both None without eviction: a
    `FrequencyTracker` per table follows the host batches (pads left out),
    and every `evict_every` steps the rows that appeared and went stale
    are evicted (`_maybe_evict`) from the stacks `evict_stacks(model)`
    names, by default the model's one stack, and marked in
    `delta_tracker`. On a mesh every rank's trackers follow the same global
    batches, so every rank evicts the same rows."""
    if not evict_every:
        return None, None
    trackers = [FrequencyTracker(v, decay=freq_decay)
                for v in cfg.vocab_sizes]
    pad_idx = getattr(cfg, "pad_idx", None)

    def track_fn(batch):
        cat = batch["cat"]
        cat = cat.cpu().numpy() if torch.is_tensor(cat) else np.asarray(cat)
        for t, tr in enumerate(trackers):
            ids = cat[t]
            if pad_idx is not None:
                # np.bincount refuses the negative pad, and a pad is no
                # traffic.
                ids = ids[ids != pad_idx]
            tr.observe(ids)

    def evict_fn(m):
        stacks = ((("tables", "emb_state"),) if evict_stacks is None
                  else evict_stacks(m))
        return _maybe_evict(m, trackers, evict_threshold, stacks,
                            delta_tracker)

    return track_fn, evict_fn


def _delta_setup(delta_ckpt, delta_every, tables):
    """The loop's delta-checkpoint plumbing: validate, point the manager at
    the layout of `tables` (flat on one device, `ModRowLayout` on a mesh),
    and build the touched-row tracker over the stacked vocab. None when
    delta checkpoints are off."""
    if delta_ckpt is None:
        return None
    if not delta_every:
        raise ValueError("delta_ckpt requires delta_every > 0")
    delta_ckpt.layout = _layout(tables)
    return TouchedRowTracker(tables.offsets[-1])


def _delta_state(model):
    """The state a CTR delta checkpoint covers beside `model.tables.data`:
    the stack's sparse optimizer state, and for DeepFM's unfolded layout
    also the first-order stack and its state (same global rows: the stacks
    share offsets, so one tracker covers both). The folded DeepFM has one
    fused stack, like DLRM and DCN."""
    fm_w = getattr(model, "fm_w", None)
    if fm_w is None:
        return model.emb_state
    return (model.emb_state, fm_w.data, model.fm_state)


def _ctr_delta_fn(delta_ckpt, delta_every, tracker, pad_idx, tel):
    """The loop's delta hook: mark the batch's rows, and every
    `delta_every` steps save the touched rows (a base at the manager's
    cadence)."""
    if tracker is None:
        return None

    def delta_fn(i, m, batch):
        tracker.observe_batch(batch["cat"], m.tables.offsets,
                              pad_idx=pad_idx)
        if (i + 1) % delta_every == 0:
            with tel.phase("delta_ckpt"):
                delta_ckpt.save(i + 1, m.tables.data, _delta_state(m),
                                tracker)

    return delta_fn


def _rank() -> int:
    """This process's rank in the default group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_agree(guard, ex, device):
    """The loss a mesh loop's guard reads: NaN on every rank when any
    rank's guard counts its loss as bad (one all-reduce of the verdict over
    the placement), so every rank rolls back together; else the loss."""
    import torch.distributed as dist

    def agree(lv):
        bad = torch.tensor([float(guard.is_bad(lv))], device=device)
        dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=ex.group)
        return float("nan") if float(bad) else lv
    return agree


def _planned_model(fam: _Family, cfg, model, mesh, plan, sparse_opt, dense_tx,
                   seed, tel):
    """The planned model to train in place (JAX's `_coerce_planned`): a
    fresh one from `seed` on the plan, a single-device model (given, or
    built from numpy arrays) carried onto it with its optimizer state
    (`parallel.planner.plan_model`), or a planned model itself; anything
    else is a `TypeError`. A planned model without tower state gets
    `dense_tx`'s."""
    from ..parallel.mesh import mesh_device
    from ..parallel.planner import plan_model
    from .dcn import DCN
    from .deepfm import DeepFM
    from .dlrm import DLRM, with_dense_tx
    cls, init_planned, _, _ = fam.planned()
    single = {"dlrm": DLRM, "dcn": DCN, "deepfm": DeepFM}[fam.name]
    if model is None:
        with tel.phase("init"):
            return init_planned(cfg, plan, mesh, sparse_opt=sparse_opt,
                                dense_tx=dense_tx, seed=seed)
    if isinstance(model, dict):
        model = fam.from_arrays(cfg, device=mesh_device(mesh), **model)
    if isinstance(model, single):
        return plan_model(model, plan, mesh, sparse_opt, dense_tx)
    if not isinstance(model, cls):
        raise TypeError(
            f"plan= expects a {single.__name__} or {cls.__name__} model, got "
            f"{type(model).__name__} (unshard a sharded model first)")
    if dense_tx is not None and model.dense_opt_state is None:
        with_dense_tx(model, dense_tx)
    return model


def _mesh_model(fam: _Family, cfg, model, mesh, axis, sparse_opt, dense_tx,
                seed, tel):
    """The sharded model to train in place: `model` itself when sharded,
    else the single-device one (given, built from numpy arrays, or the
    family's init from `seed` on this rank's device) placed by the family's
    shard function."""
    from ..parallel.mesh import mesh_device
    cls, shard, _, _ = fam.sharded()
    if isinstance(model, cls):
        return model
    model = _model_for(fam.init, fam.from_arrays, cfg, model, seed,
                       mesh_device(mesh), sparse_opt, tel, dense_tx=dense_tx)
    return shard(model, mesh, axis, sparse_opt=sparse_opt, dense_tx=dense_tx)


def _train_ctr(fam: _Family, cfg, train_iter, num_steps: int, *, sparse_opt,
               dense_lr, dense_tx, microbatch, device_prefetch, model, seed,
               eval_batches, eval_every, eval_metrics, log_every, lr_schedule,
               verbose, device, evict_every, evict_threshold, freq_decay,
               ckpt_manager, ckpt_every, guard, delta_ckpt, delta_every,
               evict_stacks=None, mesh=None, axis="data", plan=None,
               step_kw=None, tuner=None) -> TrainResult:
    """The CTR (dense/cat/label) training run of any family, on one device
    or on a `mesh` (every rank calls it with the same arguments and the
    same global batches; each steps on its data-axis block, scores every
    eval batch (each rank its block, then an all-gather) and draws its
    stochastic rounding from `rank_generator`), or on a `mesh` under a
    `plan` (the family's planned model, placed over `plan.axis`; `axis` is
    not read there, as in JAX). `step_kw`: the sharded
    DLRM step's exchange options; with a `tuner` (`CapacityAutoTuner`) the
    step reports its overflow and is rebuilt at the factor the tuner
    returns. A given `model` trained with `dense_tx` must hold its tower
    state: `ValueError` before the first step otherwise, where JAX's loop
    fails inside optax."""
    _check_schedule(sparse_opt, lr_schedule)
    tel = _telemetry.get_telemetry()
    agree = None
    if mesh is None:
        model = _model_for(fam.init, fam.from_arrays, cfg, model, seed,
                           device, sparse_opt, tel, dense_tx=dense_tx)
        require_dense_state(model, dense_tx, f"init_{fam.name}")
        device = model.tables.data.device

        def build_step(cf):
            return fam.train_step(cfg, sparse_opt=sparse_opt,
                                  dense_lr=dense_lr, dense_tx=dense_tx,
                                  microbatch=microbatch)

        eval_step = fam.eval_step(cfg)

        def put(b):
            return tuple(torch.as_tensor(b[k]).to(device, non_blocking=True)
                         for k in ("dense", "cat", "label"))

        generator = _sr_generator_for(sparse_opt, seed, device)
    else:
        from ..parallel.dlrm import _local_block, rank_generator, \
            sharded_logits, tables_device
        sparse_opt = sparse_opt or SparseSGD()
        if plan is not None:
            _, _, make_step, make_eval = fam.planned()
            model = _planned_model(fam, cfg, model, mesh, plan, sparse_opt,
                                   dense_tx, seed, tel)
            require_dense_state(model, dense_tx, f"init_planned_{fam.name}")

            def build_step(cf):
                return make_step(cfg, mesh, sparse_opt=sparse_opt,
                                 dense_lr=dense_lr, dense_tx=dense_tx,
                                 microbatch=microbatch)

            sharded_eval = make_eval(cfg, mesh)
        else:
            _, _, make_step, make_eval = fam.sharded()
            model = _mesh_model(fam, cfg, model, mesh, axis, sparse_opt,
                                dense_tx, seed, tel)
            require_dense_state(model, dense_tx, f"shard_{fam.name}")

            def build_step(cf):
                kw = ({} if step_kw is None
                      else dict(step_kw, capacity_factor=cf))
                return make_step(cfg, mesh, axis, sparse_opt=sparse_opt,
                                 dense_lr=dense_lr, dense_tx=dense_tx,
                                 microbatch=microbatch, **kw)

            sharded_eval = make_eval(cfg, mesh, axis)
        ex = model.tables.exchange
        device = tables_device(model.tables)

        def eval_step(m, dense, cat):
            return sharded_logits(m, dense, cat, sharded_eval)

        def put(b):
            block = _local_block(ex, b["dense"], b["cat"], b["label"])
            return tuple(torch.as_tensor(x).to(device, non_blocking=True)
                         for x in block)

        generator = None
        if getattr(sparse_opt, "stochastic_rounding", False):
            generator = rank_generator(seed + 1_000_003, ex.me, device)
        if guard is not None:
            agree = _mesh_agree(guard, ex, device)
        verbose = verbose and _rank() == 0

    eval_fn = _ctr_eval_fn(eval_step, eval_batches, eval_metrics)
    delta_tracker = _delta_setup(delta_ckpt, delta_every, model.tables)
    track_fn, evict_fn = _evict_hooks(cfg, evict_every, evict_threshold,
                                      freq_decay, evict_stacks, delta_tracker)

    def on_rollback():
        if delta_ckpt is not None:
            # The live model jumped back to an older snapshot: the tracker
            # no longer names the rows that differ from the last save.
            delta_ckpt.force_base()

    tuner_occ_fn = None
    if tuner is not None:
        # Routed occurrences of a step: the forward's and the update's.
        tuner_occ_fn = lambda b: (2 * b["label"].shape[0]  # noqa: E731
                                  * len(cfg.vocab_sizes) * (cfg.bag or 1))
    model, losses, aucs, eps, evicted = _run_loop(
        model=model, device=device, step=build_step(
            None if step_kw is None else step_kw["capacity_factor"]),
        put=put, train_iter=train_iter, num_steps=num_steps, tel=tel,
        batch_count=lambda b: b["label"].shape[0], lr_schedule=lr_schedule,
        generator=generator, track_fn=track_fn, evict_every=evict_every,
        evict_fn=evict_fn,
        split_out=(lambda out: out[0]) if tuner is not None else None,
        log_every=log_every, verbose=verbose, guard=guard,
        on_rollback=on_rollback, eval_every=eval_every,
        eval_batches=eval_batches, eval_fn=eval_fn,
        delta_fn=_ctr_delta_fn(delta_ckpt, delta_every, delta_tracker,
                               getattr(cfg, "pad_idx", None), tel),
        ckpt_manager=ckpt_manager, ckpt_every=ckpt_every,
        device_prefetch=device_prefetch, tuner=tuner,
        tuner_occ_fn=tuner_occ_fn, rebuild_step=build_step, agree=agree)
    return TrainResult(model=model, losses=losses, aucs=aucs,
                       examples_per_sec=eps, evicted_rows=evicted)


def train_dlrm(cfg: DLRMConfig, train_iter: Iterator[dict], num_steps: int, *,
               sparse_opt=None, dense_lr: float = 0.01, dense_tx=None,
               model=None, seed: int = 0, eval_batches: Optional[list] = None,
               eval_every: int = 0, ckpt_manager=None, ckpt_every: int = 0,
               log_every: int = 100, mesh=None, axis: str = "data",
               exchange: str = "gather", capacity_factor: float = 2.0,
               auto_capacity: bool = False, wire_dtype=None, guard=None,
               evict_every: int = 0, evict_threshold: float = 1e-3,
               freq_decay: float = 0.99, microbatch=None,
               device_prefetch: int = 0, plan=None,
               eval_metrics: bool = False, lr_schedule=None,
               delta_ckpt=None, delta_every: int = 0, verbose: bool = True,
               device=None) -> TrainResult:
    """Train a DLRM for `num_steps` batches from `train_iter` on one device.

    `model` is trained in place; without one, `init_dlrm` builds one on
    `device` (CUDA unless given) from `seed`. `lr_schedule(step)` sets the
    sparse optimizer's lr per step. `losses` holds the loss at every
    `log_every`-th step and the last; `aucs` the eval AUC every `eval_every`
    steps (`eval_metrics=True` also prints log loss, normalized entropy and
    calibration).

    `evict_every > 0` turns on row lifecycle management: a
    `utils.rowstats.FrequencyTracker` (decay `freq_decay`) follows each
    table's traffic from the host batches, and every `evict_every` steps the
    rows that appeared and then went stale (decayed count at or below
    `evict_threshold`) are zeroed and their optimizer state reset;
    `evicted_rows` counts them. Never-seen rows keep their init values.

    `ckpt_manager` (a `utils.CheckpointManager`) with `ckpt_every > 0` saves
    the whole model every `ckpt_every` steps. `guard` (a
    `utils.DivergenceGuard`) reads the loss at the log cadence and, on a
    divergence, copies its last checkpoint into the model in place (and
    makes `delta_ckpt`'s next save a base). `delta_ckpt` (a
    `utils.DeltaCheckpointManager`) with `delta_every > 0` saves the rows
    touched since the last save every `delta_every` steps, with the sparse
    optimizer state's rows (a full base at the manager's `base_every`
    cadence); evicted rows count as touched. It covers
    `(tables.data, emb_state)`; resume with `restore_delta`.

    `dense_tx` (a factory from the tower parameters to a
    `torch.optim.Optimizer`, e.g. `functools.partial(torch.optim.Adam,
    lr=1e-3)`) steps the towers in place of plain SGD at `dense_lr`; a
    fresh model is built with its state, and a given one must hold it
    (`init_dlrm(dense_tx=)`). `microbatch=k` takes each step's gradients over
    k slices of the batch (`make_train_step`). `device_prefetch=n` copies
    the next n batches to the card on a side stream beside the step; the
    results are bitwise those without it.

    `mesh` (a `DeviceMesh`, `parallel.mesh`) trains the sharded DLRM on
    every rank of the mesh, each calling `train_dlrm` with the same
    arguments and the same global batches: `axis` names the placement
    (`"data"`, or `("data", "model")`), `exchange` the lookup and update
    exchange ("gather", or the "a2a" butterfly with `capacity_factor`,
    `auto_capacity` and `wire_dtype`). The result's model is the
    `parallel.dlrm.ShardedDLRM`; `device` is the mesh's. The checkpoints,
    the guard, delta checkpoints and eviction hold on the mesh too (the
    module docstring). With `plan` (a `parallel.planner.ShardingPlan`)
    beside `mesh`, the model is a `parallel.planner.PlannedDLRM` on the
    plan's placement (made fresh, carried from a single-device `model` with
    its optimizer state, or given); it evicts, checkpoints and rolls back
    as on the mesh, and `delta_ckpt` raises `NotImplementedError`, as in
    JAX.

    JAX's invalid combinations of options raise JAX's errors
    (`unported.check_jax_combinations`), as does an `lr_schedule` with
    `SparseFTRL` (alpha is baked into its state), before the first step, as
    the JAX loop's first step does."""
    check_jax_combinations(exchange=exchange, wire_dtype=wire_dtype,
                           delta_ckpt=delta_ckpt, delta_every=delta_every,
                           mesh=mesh, plan=plan)
    step_kw = tuner = None
    if mesh is not None:
        from ..parallel.alltoall import CapacityAutoTuner
        with_overflow = exchange == "a2a" and auto_capacity
        step_kw = dict(exchange=exchange, capacity_factor=capacity_factor,
                       with_overflow=with_overflow, wire_dtype=wire_dtype)
        if with_overflow:
            tuner = CapacityAutoTuner(capacity_factor, 1)  # occ: 1st batch
    return _train_ctr(
        _dlrm_family(), cfg, train_iter, num_steps, sparse_opt=sparse_opt,
        dense_lr=dense_lr, dense_tx=dense_tx, microbatch=microbatch,
        device_prefetch=device_prefetch, model=model, seed=seed,
        eval_batches=eval_batches, eval_every=eval_every,
        eval_metrics=eval_metrics, log_every=log_every,
        lr_schedule=lr_schedule, verbose=verbose, device=device,
        evict_every=evict_every, evict_threshold=evict_threshold,
        freq_decay=freq_decay, ckpt_manager=ckpt_manager,
        ckpt_every=ckpt_every, guard=guard, delta_ckpt=delta_ckpt,
        delta_every=delta_every, mesh=mesh, axis=axis, plan=plan,
        step_kw=step_kw, tuner=tuner)


def train_dcn(cfg, train_iter: Iterator[dict], num_steps: int, *,
              sparse_opt=None, dense_lr: float = 0.01, dense_tx=None,
              model=None, seed: int = 0, eval_batches: Optional[list] = None,
              eval_every: int = 0, ckpt_manager=None, ckpt_every: int = 0,
              log_every: int = 100, mesh=None, axis: str = "data",
              microbatch=None, guard=None, device_prefetch: int = 0,
              plan=None, evict_every: int = 0, evict_threshold: float = 1e-3,
              freq_decay: float = 0.99, eval_metrics: bool = False,
              lr_schedule=None, delta_ckpt=None, delta_every: int = 0,
              verbose: bool = True, device=None) -> TrainResult:
    """Train a DCN-v2 (`models/dcn.py`) on `train_dlrm`'s batches, cadence
    and options: row eviction, checkpoints, the guard and delta checkpoints
    included; with `mesh` the sharded DCN (`parallel.dcn`) on the gather
    exchange, or with `plan` too the planned DCN, `train_dlrm`'s
    contract."""
    check_jax_combinations(delta_ckpt=delta_ckpt, delta_every=delta_every,
                           mesh=mesh, plan=plan)
    return _train_ctr(
        _dcn_family(), cfg, train_iter, num_steps, sparse_opt=sparse_opt,
        dense_lr=dense_lr, dense_tx=dense_tx, microbatch=microbatch,
        device_prefetch=device_prefetch, model=model, seed=seed,
        eval_batches=eval_batches, eval_every=eval_every,
        eval_metrics=eval_metrics, log_every=log_every,
        lr_schedule=lr_schedule, verbose=verbose, device=device,
        evict_every=evict_every, evict_threshold=evict_threshold,
        freq_decay=freq_decay, ckpt_manager=ckpt_manager,
        ckpt_every=ckpt_every, guard=guard, delta_ckpt=delta_ckpt,
        delta_every=delta_every, mesh=mesh, axis=axis, plan=plan)


def train_deepfm(cfg, train_iter: Iterator[dict], num_steps: int, *,
                 sparse_opt=None, dense_lr: float = 0.01, dense_tx=None,
                 model=None, seed: int = 0,
                 eval_batches: Optional[list] = None, eval_every: int = 0,
                 ckpt_manager=None, ckpt_every: int = 0,
                 log_every: int = 100, mesh=None, axis: str = "data",
                 guard=None, device_prefetch: int = 0, plan=None,
                 evict_every: int = 0, evict_threshold: float = 1e-3,
                 freq_decay: float = 0.99, eval_metrics: bool = False,
                 microbatch=None, lr_schedule=None, delta_ckpt=None,
                 delta_every: int = 0, verbose: bool = True,
                 device=None) -> TrainResult:
    """Train a DeepFM (`models/deepfm.py`, either layout) on `train_dlrm`'s
    batches, cadence and options. Row eviction covers every stack: a stale
    row loses its FM vector, its first-order weight and their optimizer
    state, in the fused row of the folded layout or in both stacks of the
    unfolded one. A delta checkpoint of the unfolded layout carries the
    first-order stack and its state beside the FM stack's. With `mesh` the
    sharded DeepFM (`parallel.deepfm`, either layout), or with `plan` too
    the planned folded DeepFM (the plan's dim is `cfg.stack_dim`),
    `train_dlrm`'s contract."""

    def evict_stacks(m):
        fm = () if getattr(m, "fm_w", None) is None else (("fm_w",
                                                           "fm_state"),)
        return (("tables", "emb_state"),) + fm

    check_jax_combinations(delta_ckpt=delta_ckpt, delta_every=delta_every,
                           mesh=mesh, plan=plan)
    return _train_ctr(
        _deepfm_family(), cfg, train_iter, num_steps, sparse_opt=sparse_opt,
        dense_lr=dense_lr, dense_tx=dense_tx, microbatch=microbatch,
        device_prefetch=device_prefetch, model=model, seed=seed,
        eval_batches=eval_batches, eval_every=eval_every,
        eval_metrics=eval_metrics, log_every=log_every,
        lr_schedule=lr_schedule, verbose=verbose, device=device,
        evict_every=evict_every, evict_threshold=evict_threshold,
        freq_decay=freq_decay, ckpt_manager=ckpt_manager,
        ckpt_every=ckpt_every, guard=guard, delta_ckpt=delta_ckpt,
        delta_every=delta_every, evict_stacks=evict_stacks, mesh=mesh,
        axis=axis, plan=plan)


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------

def _planned_two_tower(cfg, model, mesh, q_plan, i_plan, sparse_opt, seed,
                       tel):
    """The planned two-tower model to train in place (JAX's branch order):
    a fresh one from `seed` on the plans, a single-device model (given, or
    built from numpy arrays) carried onto them with its optimizer state, or
    a `PlannedTwoTower` itself; anything else is a `TypeError`."""
    from ..interop import two_tower_from_arrays
    from ..parallel import planner as pp
    from ..parallel.mesh import mesh_device
    from .two_tower import TwoTower
    if model is None:
        with tel.phase("init"):
            return pp.init_planned_two_tower(cfg, q_plan, i_plan, mesh,
                                             sparse_opt=sparse_opt, seed=seed)
    if isinstance(model, dict):
        model = two_tower_from_arrays(cfg, device=mesh_device(mesh), **model)
    if isinstance(model, TwoTower):
        return pp.place_two_tower_on_plan(q_plan, i_plan, mesh, model,
                                          sparse_opt)
    if not isinstance(model, pp.PlannedTwoTower):
        raise TypeError(
            f"plan= expects a TwoTower or PlannedTwoTower model, got "
            f"{type(model).__name__} (unshard a sharded model first)")
    return model


def train_two_tower(cfg, train_iter: Iterator[dict], num_steps: int, *,
                    sparse_opt=None, dense_lr: float = 0.05, model=None,
                    seed: int = 0, eval_batches=None, eval_every: int = 0,
                    k: int = 10, ckpt_manager=None, ckpt_every: int = 0,
                    log_every: int = 100, mesh=None, axis: str = "data",
                    device_prefetch: int = 0, plan=None, delta_ckpt=None,
                    delta_every: int = 0, verbose: bool = True,
                    device=None) -> RetrievalTrainResult:
    """Train a two-tower retriever for `num_steps` batches from `train_iter`
    (dicts with dense/q_cat/item_ids, `data.SyntheticRetrieval`'s layout)
    on one device. `accs` holds the in-batch top-1 accuracy at the log
    cadence; every `eval_every` steps the item index is rebuilt and the
    recall@k of the positive item over `eval_batches` joins `recalls`.
    `ckpt_manager` / `ckpt_every` save the whole model; `delta_ckpt` is a
    `(query_mgr, item_mgr)` pair of `utils.DeltaCheckpointManager`s, one per
    row space (the query stack and the item table, each with its own
    tracker), saved every `delta_every` steps; resume with
    `restore_delta`. With `mesh` (every rank calls it with the same
    arguments and batches) the sharded step (`parallel.two_tower`) trains
    on each rank's data-axis block, the recall comes from the sharded
    retriever over the block-row index of the unsharded model, and the
    result's model is unsharded, as JAX's. With `plan=(q_plan, i_plan)`
    beside `mesh` the model is a `parallel.planner.PlannedTwoTower` (made
    fresh, carried from a single-device `model` with its optimizer state,
    or given; anything else is JAX's `TypeError`), the batch splits over
    `q_plan.axis`, the recall comes from the planned index and retrieval,
    full checkpoints are saved by every rank of the placement, and the
    result carries the planned model, as JAX's; `delta_ckpt` with a plan
    raises JAX's `NotImplementedError`."""
    from . import two_tower as tt
    from ..interop import two_tower_from_arrays
    check_jax_combinations(delta_ckpt=delta_ckpt, delta_every=delta_every,
                           mesh=mesh, plan=plan)
    tel = _telemetry.get_telemetry()
    sparse_opt = sparse_opt or SparseSGD(0.05)
    if mesh is None:
        model = _model_for(tt.init_two_tower, two_tower_from_arrays, cfg,
                           model, seed, device, sparse_opt, tel)
        device = model.item_data.device
        step = tt.make_train_step(cfg, sparse_opt=sparse_opt,
                                  dense_lr=dense_lr)

        def put(b):
            return tuple(torch.as_tensor(b[key]).to(device, non_blocking=True)
                         for key in ("dense", "q_cat", "item_ids"))

        def retriever(m):
            return tt.build_item_index(m), tt.make_retriever(m, k=k)

        generator = _sr_generator_for(sparse_opt, seed, device)
        to_dense = None
    else:
        from ..parallel import two_tower as ptt
        from ..parallel.dlrm import rank_generator
        from ..parallel.mesh import mesh_device
        if plan is not None:
            from ..parallel import planner as pp
            q_plan, i_plan = plan
            model = _planned_two_tower(cfg, model, mesh, q_plan, i_plan,
                                       sparse_opt, seed, tel)
            ex = model.query_tables.exchange
            device = model.query_tables.device
            step = pp.make_planned_tt_train_step(cfg, mesh,
                                                 sparse_opt=sparse_opt,
                                                 dense_lr=dense_lr)
            shardings = ptt.tt_batch_shardings(mesh, q_plan.axis)

            def retriever(m):
                index = pp.planned_build_item_index(mesh, m)
                return index, (lambda index, dense, q_cat: pp.planned_retrieve(
                    mesh, m, index, dense, q_cat, k=k))

            to_dense = None
        else:
            if not isinstance(model, ptt.ShardedTwoTower):
                model = ptt.shard_two_tower(
                    _model_for(tt.init_two_tower, two_tower_from_arrays, cfg,
                               model, seed, mesh_device(mesh), sparse_opt,
                               tel), mesh, axis, sparse_opt=sparse_opt)
            ex = model.query_tables.exchange
            device = model.query_tables.data.device
            step = ptt.make_sharded_tt_train_step(cfg, mesh, axis,
                                                  sparse_opt=sparse_opt,
                                                  dense_lr=dense_lr)
            shardings = ptt.tt_batch_shardings(mesh, axis)

            def retriever(m):
                single = ptt.unshard_two_tower(m)
                return (ptt.build_sharded_item_index(single, mesh, axis),
                        ptt.make_sharded_retriever(single, mesh, k=k,
                                                   axis=axis))

            to_dense = ptt.unshard_two_tower

        def put(b):
            return tuple(torch.as_tensor(f(b[key])).to(device,
                                                        non_blocking=True)
                         for f, key in zip(shardings,
                                           ("dense", "q_cat", "item_ids")))

        generator = None
        if getattr(sparse_opt, "stochastic_rounding", False):
            generator = rank_generator(seed + 1_000_003, ex.me, device)
        verbose = verbose and _rank() == 0

    def eval_fn(m):
        index, run = retriever(m)
        hits, total = 0.0, 0
        for b in eval_batches:
            _, ids = run(index, b["dense"], b["q_cat"])
            n = b["item_ids"].shape[0]
            hits += recall_at_k(b["item_ids"], ids.cpu().numpy()) * n
            total += n
        r = hits / max(total, 1)
        return r, f"recall@{k} {r:.4f}"

    delta_fn = None
    if delta_ckpt is not None:
        # Two managers: the query stack and the item corpus are two row
        # spaces, each with its own touched set.
        q_mgr, i_mgr = delta_ckpt
        q_mgr.layout = _layout(model.query_tables)
        i_mgr.layout = _layout(model.item_table)
        q_tracker = TouchedRowTracker(model.query_tables.offsets[-1])
        i_tracker = TouchedRowTracker(cfg.item_vocab)

        def delta_fn(i, m, batch):
            q_tracker.observe_batch(batch["q_cat"], m.query_tables.offsets)
            i_tracker.observe(batch["item_ids"])
            if (i + 1) % delta_every == 0:
                with tel.phase("delta_ckpt"):
                    q_mgr.save(i + 1, m.query_tables.data, m.q_state,
                               q_tracker)
                    i_mgr.save(i + 1, m.item_table.data, m.i_state,
                               i_tracker)

    # The step returns (loss, in-batch accuracy); the loop logs the loss,
    # on_log records and prints the accuracy.
    accs, last_acc = [], {}

    def split_out(out):
        last_acc["acc"] = out[1]
        return out[0]

    def on_log(i, lv):
        accs.append(float(last_acc["acc"]))
        if verbose:
            print(f"step {i:6d}  loss {lv:.5f}  in-batch acc {accs[-1]:.3f}",
                  flush=True)

    model, losses, recalls, eps, _ = _run_loop(
        model=model, device=device, step=step, put=put, train_iter=train_iter,
        num_steps=num_steps, tel=tel,
        batch_count=lambda b: b["item_ids"].shape[0], generator=generator,
        split_out=split_out, log_every=log_every, verbose=verbose,
        on_log=on_log, eval_every=eval_every, eval_batches=eval_batches,
        eval_fn=eval_fn, delta_fn=delta_fn, ckpt_manager=ckpt_manager,
        ckpt_every=ckpt_every, device_prefetch=device_prefetch)
    return RetrievalTrainResult(
        model=model if to_dense is None else to_dense(model), losses=losses,
        accs=accs, recalls=recalls, examples_per_sec=eps)


# ---------------------------------------------------------------------------
# Delta-checkpoint restore (one restore for every family)
# ---------------------------------------------------------------------------

def restore_delta(delta_ckpt, model):
    """Resume `model`'s tables and sparse optimizer state from the
    `DeltaCheckpointManager` chain(s) a `train_*` loop's `delta_ckpt=`
    wrote, in place; returns `model`.

    One entry point for every family (the three per-family names below are
    aliases): DLRM and DCN, DeepFM in both layouts (the unfolded
    first-order stack restores beside the FM stack), and the two-tower
    retriever (pass the `(query_mgr, item_mgr)` pair `train_two_tower`
    took). A sharded model restores through its tables' `ModRowLayout`
    (every rank calls it), whatever layout the chain was written in. The
    dense towers are not in the chain: pair with a `ckpt_manager` when they
    must resume too. A directory without a committed base leaves its tables
    as they are."""
    if hasattr(model, "query_tables"):
        q_mgr, i_mgr = delta_ckpt
        q_mgr.layout = _layout(model.query_tables)
        i_mgr.layout = _layout(model.item_table)
        q_mgr.restore_latest(model.query_tables.data, model.q_state)
        i_mgr.restore_latest(model.item_table.data, model.i_state)
        return model
    delta_ckpt.layout = _layout(model.tables)
    delta_ckpt.restore_latest(model.tables.data, _delta_state(model))
    return model


# JAX's per-family names (the same function).
restore_dlrm_delta = restore_delta
restore_deepfm_delta = restore_delta
restore_two_tower_delta = restore_delta

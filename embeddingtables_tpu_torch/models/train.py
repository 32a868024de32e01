"""The single-device training loops (counterpart of
`embeddingtables_tpu/models/train.py`): one loop behind four thin entry
points.

  - `_Family` names one CTR family's init, train-step and eval-step
    factories and its `*_from_arrays` builder; `_train_ctr` trains any of
    them on `dense`/`cat`/`label` batches. `train_dlrm`, `train_dcn` and
    `train_deepfm` are thin calls.
  - `_run_loop` owns the per-step cadence for every family: fetch a host
    batch, feed the frequency trackers, move the batch to the model's
    device, run the step (which updates the model in place), evict stale
    rows every `evict_every` steps, read the loss back at the log cadence,
    evaluate at `eval_every`. `train_two_tower` runs it with its own
    batches, step and recall@k eval.

Every loop takes every parameter of its JAX counterpart. The mesh,
planner, checkpoint, guard, prefetch, microbatch and `dense_tx` options are
not ported yet: `unported.py` holds their table, and a value other than the
one that leaves an option off raises `NotImplementedError`.
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
from ..optim import SparseFTRL, SparseSGD
from ..unported import check_jax_combinations, refuse_unported
from ..utils.rowstats import FrequencyTracker, evict_rows, reset_rows_state
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


def _refuse(loop: str, *, exchange="gather", wire_dtype=None, delta_every=0,
            **unported) -> None:
    """JAX's own errors on `unported`'s combinations first, then the
    unported options that are set (the rest of JAX's options are ignored,
    as `unported.py` says)."""
    check_jax_combinations(
        mesh=unported.get("mesh"), plan=unported.get("plan"),
        delta_ckpt=unported.get("delta_ckpt"), delta_every=delta_every,
        wire_dtype=wire_dtype, exchange=exchange)
    refuse_unported(loop, **unported)


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


def _run_loop(*, model, device, step, put, train_iter, num_steps,
              batch_count, lr_schedule=None, generator=None, track_fn=None,
              evict_every=0, evict_fn=None, split_out=None, log_every=100,
              verbose=True, on_log=None, eval_every=0, eval_batches=None,
              eval_fn=None):
    """The shared per-step cadence. Hooks:

      put(batch) -> args              the step's positional inputs
      track_fn(batch)                 feed the frequency trackers
      evict_fn(model) -> n            at the evict_every cadence, in place
      split_out(out) -> loss          default: the output is the loss
      on_log(i, loss_value)           replaces the default log line
      eval_fn(model) -> (value, line) at the eval_every cadence

    Returns (losses, evals, examples_per_sec, evicted_total)."""
    losses, evals = [], []
    examples = 0
    evicted_total = 0
    t_start = time.perf_counter()
    for i in range(num_steps):
        batch = next(train_iter)
        if track_fn is not None:
            track_fn(batch)
        kw = {} if generator is None else {"generator": generator}
        if lr_schedule is not None:
            kw["lr"] = lr_schedule(i)
        out = step(model, *put(batch), **kw)
        if evict_fn is not None and (i + 1) % evict_every == 0:
            # Only rows seen and then gone stale (never-seen rows sit at
            # their init values), each popped so it is not evicted again
            # unless it reappears.
            evicted_total += evict_fn(model)
        loss = out if split_out is None else split_out(out)
        examples += batch_count(batch)
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            lv = float(loss)       # waits for the step: keeps the rate honest
            losses.append(lv)
            if on_log is not None:
                on_log(i, lv)
            elif verbose:
                print(f"step {i:6d}  loss {lv:.5f}", flush=True)
        if eval_every and eval_batches and (i + 1) % eval_every == 0:
            value, line = eval_fn(model)
            evals.append((i + 1, value))
            if verbose:
                print(f"step {i + 1:6d}  {line}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (losses, evals, examples / (time.perf_counter() - t_start),
            evicted_total)


# ---------------------------------------------------------------------------
# The CTR families and their loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Family:
    """One CTR family on one device: its init, train-step and eval-step
    factories, and its builder from numpy arrays (`model=` may be the
    builder's keyword arguments, a model trained by the JAX package)."""

    name: str
    init: Callable         # (cfg, generator, device=, sparse_opt=) -> model
    train_step: Callable   # (cfg, sparse_opt=, dense_lr=) -> step
    eval_step: Callable    # (cfg) -> step
    from_arrays: Callable  # (cfg, device=, **arrays) -> model


def _dlrm_family() -> _Family:
    from . import dlrm
    from ..interop import dlrm_from_arrays
    return _Family("dlrm", dlrm.init_dlrm, dlrm.make_train_step,
                   dlrm.make_eval_step, dlrm_from_arrays)


def _dcn_family() -> _Family:
    from . import dcn
    from ..interop import dcn_from_arrays
    return _Family("dcn", dcn.init_dcn, dcn.make_train_step,
                   dcn.make_eval_step, dcn_from_arrays)


def _deepfm_family() -> _Family:
    from . import deepfm
    from ..interop import deepfm_from_arrays
    return _Family("deepfm", deepfm.init_deepfm, deepfm.make_train_step,
                   deepfm.make_eval_step, deepfm_from_arrays)


def _model_for(init, from_arrays, cfg, model, seed: int, device,
               sparse_opt):
    """The model to train in place: `model` itself, one built from numpy
    arrays (`model` a dict of `from_arrays`'s keyword arguments), or a fresh
    `init` from `seed` on `device` (CUDA unless given)."""
    if isinstance(model, dict):
        return from_arrays(cfg, device=resolve_device(device), **model)
    if model is not None:
        return model
    device = resolve_device(device)
    return init(cfg, torch.Generator(device=device).manual_seed(seed),
                device=device, sparse_opt=sparse_opt)


def _maybe_evict(model, trackers, evict_threshold: float, stacks) -> int:
    """Pop each tracker's stale rows and evict them from the model, in
    place: every stack of `stacks` (`(tables, state)` attribute names
    sharing the first stack's offsets) gets the rows zeroed and its
    optimizer state reset at them. DeepFM's unfolded layout passes its
    first-order stack too, so a stale row loses both representations and
    both states. Returns the number of rows evicted."""
    first = getattr(model, stacks[0][0])
    cold = np.concatenate([tr.pop_cold(evict_threshold) + first.offsets[t]
                           for t, tr in enumerate(trackers)])
    if not cold.size:
        return 0
    rows = torch.from_numpy(cold.astype(np.int64)).to(first.data.device)
    for tables_attr, state_attr in stacks:
        evict_rows(getattr(model, tables_attr).data, rows)
        reset_rows_state(getattr(model, state_attr), rows)
    return int(cold.size)


def _evict_hooks(cfg, evict_every: int, evict_threshold: float,
                 freq_decay: float, evict_stacks=None):
    """(track_fn, evict_fn) of the loop, both None without eviction: a
    `FrequencyTracker` per table follows the host batches (pads left out),
    and every `evict_every` steps the rows that appeared and went stale
    are evicted (`_maybe_evict`) from the stacks `evict_stacks(model)`
    names, by default the model's one stack."""
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
        return _maybe_evict(m, trackers, evict_threshold, stacks)

    return track_fn, evict_fn


def _train_ctr(fam: _Family, cfg, train_iter, num_steps: int, *, sparse_opt,
               dense_lr, model, seed, eval_batches, eval_every, eval_metrics,
               log_every, lr_schedule, verbose, device, evict_every,
               evict_threshold, freq_decay, evict_stacks=None) -> TrainResult:
    """The CTR (dense/cat/label) training run of any family."""
    if lr_schedule is not None and isinstance(sparse_opt, SparseFTRL):
        raise ValueError(
            "SparseFTRL cannot change lr per step: alpha is baked into the "
            "accumulated z state, so it takes no lr_schedule")
    model = _model_for(fam.init, fam.from_arrays, cfg, model, seed, device,
                       sparse_opt)
    device = model.tables.data.device
    step = fam.train_step(cfg, sparse_opt=sparse_opt, dense_lr=dense_lr)
    eval_step = fam.eval_step(cfg)

    def put(b):
        return tuple(torch.as_tensor(b[k]).to(device)
                     for k in ("dense", "cat", "label"))

    def eval_fn(m):
        if eval_metrics:
            met = evaluate_metrics(eval_step, m, eval_batches)
            return met["auc"], (
                f"eval AUC {met['auc']:.4f}  logloss {met['log_loss']:.5f}  "
                f"NE {met['normalized_entropy']:.4f}  calib "
                f"{met['calibration']:.3f}")
        a = evaluate_auc(eval_step, m, eval_batches)
        return a, f"eval AUC {a:.4f}"

    track_fn, evict_fn = _evict_hooks(cfg, evict_every, evict_threshold,
                                      freq_decay, evict_stacks)
    losses, aucs, eps, evicted = _run_loop(
        model=model, device=device, step=step, put=put, train_iter=train_iter,
        num_steps=num_steps, batch_count=lambda b: b["label"].shape[0],
        lr_schedule=lr_schedule,
        generator=_sr_generator_for(sparse_opt, seed, device),
        track_fn=track_fn, evict_every=evict_every, evict_fn=evict_fn,
        log_every=log_every, verbose=verbose, eval_every=eval_every,
        eval_batches=eval_batches, eval_fn=eval_fn)
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

    JAX's other options follow `unported.py`: set, an unported one raises,
    as does an `lr_schedule` with `SparseFTRL` (alpha is baked into its
    state), before the first step, as the JAX loop's first step does."""
    _refuse("train_dlrm", exchange=exchange, wire_dtype=wire_dtype,
            delta_every=delta_every, mesh=mesh, plan=plan,
            delta_ckpt=delta_ckpt, dense_tx=dense_tx,
            ckpt_manager=ckpt_manager, guard=guard, microbatch=microbatch,
            device_prefetch=device_prefetch)
    return _train_ctr(
        _dlrm_family(), cfg, train_iter, num_steps, sparse_opt=sparse_opt,
        dense_lr=dense_lr, model=model, seed=seed, eval_batches=eval_batches,
        eval_every=eval_every, eval_metrics=eval_metrics, log_every=log_every,
        lr_schedule=lr_schedule, verbose=verbose, device=device,
        evict_every=evict_every, evict_threshold=evict_threshold,
        freq_decay=freq_decay)


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
    and options, row eviction included."""
    _refuse("train_dcn", delta_every=delta_every, mesh=mesh, plan=plan,
            delta_ckpt=delta_ckpt, dense_tx=dense_tx,
            ckpt_manager=ckpt_manager, guard=guard, microbatch=microbatch,
            device_prefetch=device_prefetch)
    return _train_ctr(
        _dcn_family(), cfg, train_iter, num_steps, sparse_opt=sparse_opt,
        dense_lr=dense_lr, model=model, seed=seed, eval_batches=eval_batches,
        eval_every=eval_every, eval_metrics=eval_metrics, log_every=log_every,
        lr_schedule=lr_schedule, verbose=verbose, device=device,
        evict_every=evict_every, evict_threshold=evict_threshold,
        freq_decay=freq_decay)


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
    unfolded one."""

    def evict_stacks(m):
        fm = () if m.fm_w is None else (("fm_w", "fm_state"),)
        return (("tables", "emb_state"),) + fm

    _refuse("train_deepfm", delta_every=delta_every, mesh=mesh, plan=plan,
            delta_ckpt=delta_ckpt, dense_tx=dense_tx,
            ckpt_manager=ckpt_manager, guard=guard, microbatch=microbatch,
            device_prefetch=device_prefetch)
    return _train_ctr(
        _deepfm_family(), cfg, train_iter, num_steps, sparse_opt=sparse_opt,
        dense_lr=dense_lr, model=model, seed=seed, eval_batches=eval_batches,
        eval_every=eval_every, eval_metrics=eval_metrics, log_every=log_every,
        lr_schedule=lr_schedule, verbose=verbose, device=device,
        evict_every=evict_every, evict_threshold=evict_threshold,
        freq_decay=freq_decay, evict_stacks=evict_stacks)


# ---------------------------------------------------------------------------
# Retrieval
# ---------------------------------------------------------------------------

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
    JAX's other options follow `unported.py`."""
    from . import two_tower as tt
    from ..interop import two_tower_from_arrays
    _refuse("train_two_tower", delta_every=delta_every, mesh=mesh, plan=plan,
            delta_ckpt=delta_ckpt, ckpt_manager=ckpt_manager,
            device_prefetch=device_prefetch)
    sparse_opt = sparse_opt or SparseSGD(0.05)
    model = _model_for(tt.init_two_tower, two_tower_from_arrays, cfg, model,
                       seed, device, sparse_opt)
    device = model.item_data.device
    step = tt.make_train_step(cfg, sparse_opt=sparse_opt, dense_lr=dense_lr)

    def put(b):
        return tuple(torch.as_tensor(b[key]).to(device)
                     for key in ("dense", "q_cat", "item_ids"))

    def eval_fn(m):
        index = tt.build_item_index(m)
        retriever = tt.make_retriever(m, k=k)
        hits, total = 0.0, 0
        for b in eval_batches:
            _, ids = retriever(index, b["dense"], b["q_cat"])
            n = b["item_ids"].shape[0]
            hits += recall_at_k(b["item_ids"], ids.cpu().numpy()) * n
            total += n
        r = hits / max(total, 1)
        return r, f"recall@{k} {r:.4f}"

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

    losses, recalls, eps, _ = _run_loop(
        model=model, device=device, step=step, put=put, train_iter=train_iter,
        num_steps=num_steps, batch_count=lambda b: b["item_ids"].shape[0],
        generator=_sr_generator_for(sparse_opt, seed, device),
        split_out=split_out, log_every=log_every, verbose=verbose,
        on_log=on_log, eval_every=eval_every, eval_batches=eval_batches,
        eval_fn=eval_fn)
    return RetrievalTrainResult(model=model, losses=losses, accs=accs,
                                recalls=recalls, examples_per_sec=eps)

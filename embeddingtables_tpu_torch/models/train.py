"""The single-device DLRM training loop (counterpart of
`embeddingtables_tpu/models/train.py::train_dlrm`).

Per step: fetch a host batch, move it to the model's device, run
`make_train_step` (which updates the model in place), and at the log cadence
read the loss back. Eval AUC runs at `eval_every`. The JAX loop's mesh,
planner, eviction, checkpoint, guard and prefetch options are not ported yet:
setting one raises `NotImplementedError`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..metrics import auc
from .dlrm import DLRMConfig, init_dlrm, make_eval_step, make_train_step

# Options of the JAX `train_dlrm` that the port does not have yet, with the
# value that leaves each off.
_NOT_PORTED = {"mesh": None, "plan": None, "exchange": "gather",
               "evict_every": 0, "delta_ckpt": None, "ckpt_manager": None,
               "guard": None, "device_prefetch": 0, "microbatch": None,
               "dense_tx": None}


@dataclasses.dataclass
class TrainResult:
    model: object
    losses: list
    aucs: list            # [(step, auc)]
    examples_per_sec: float
    evicted_rows: int = 0


def evaluate_auc(eval_step, model, batches) -> float:
    """AUC of `eval_step`'s logits over host `batches`."""
    labels, scores = [], []
    for b in batches:
        labels.append(b["label"])
        scores.append(eval_step(model, b["dense"], b["cat"]).float().cpu()
                      .numpy())
    return auc(np.concatenate(labels), np.concatenate(scores))


def _sr_generator_for(sparse_opt, seed: int, device: torch.device):
    """The stochastic-rounding generator when the optimizer rounds
    stochastically: seeded once from `seed`, advanced by every step, so each
    step draws fresh noise."""
    if getattr(sparse_opt, "stochastic_rounding", False):
        return torch.Generator(device=device).manual_seed(seed + 1_000_003)
    return None


def train_dlrm(cfg: DLRMConfig, train_iter: Iterator[dict], num_steps: int, *,
               sparse_opt=None, dense_lr: float = 0.01, model=None,
               seed: int = 0, eval_batches: Optional[list] = None,
               eval_every: int = 0, log_every: int = 100, lr_schedule=None,
               verbose: bool = True, device=None,
               **not_ported) -> TrainResult:
    """Train a DLRM for `num_steps` batches from `train_iter` on one device.

    `model` is trained in place; without one, `init_dlrm` builds one on
    `device` (CUDA unless given) from `seed`. `lr_schedule(step)` sets the
    sparse optimizer's lr per step. `losses` holds the loss at every
    `log_every`-th step and the last; `aucs` the eval AUC every `eval_every`
    steps. The options of `_NOT_PORTED` raise when set."""
    for name, value in not_ported.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"train_dlrm() got an unexpected keyword "
                            f"argument {name!r}")
        if value != _NOT_PORTED[name]:
            raise NotImplementedError(
                f"train_dlrm({name}=...) is not ported yet")
    if model is None:
        device = resolve_device(device)
        model = init_dlrm(cfg, torch.Generator(device=device).manual_seed(seed),
                          device=device, sparse_opt=sparse_opt)
    device = model.tables.data.device
    step = make_train_step(cfg, sparse_opt=sparse_opt, dense_lr=dense_lr)
    eval_step = make_eval_step(cfg)
    generator = _sr_generator_for(sparse_opt, seed, device)
    losses, aucs = [], []
    examples = 0
    t_start = time.perf_counter()
    for i in range(num_steps):
        batch = next(train_iter)
        lr = None if lr_schedule is None else lr_schedule(i)
        loss = step(model, torch.as_tensor(batch["dense"]).to(device),
                    torch.as_tensor(batch["cat"]).to(device),
                    torch.as_tensor(batch["label"]).to(device), lr=lr,
                    generator=generator)
        examples += batch["label"].shape[0]
        if log_every and (i % log_every == 0 or i == num_steps - 1):
            lv = float(loss)       # waits for the step: keeps the rate honest
            losses.append(lv)
            if verbose:
                print(f"step {i:6d}  loss {lv:.5f}", flush=True)
        if eval_every and eval_batches and (i + 1) % eval_every == 0:
            a = evaluate_auc(eval_step, model, eval_batches)
            aucs.append((i + 1, a))
            if verbose:
                print(f"step {i + 1:6d}  eval AUC {a:.4f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t_start
    return TrainResult(model=model, losses=losses, aucs=aucs,
                       examples_per_sec=examples / dt)

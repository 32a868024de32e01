"""What the training command lines share: the `--device` flag, the mesh of a
`--mesh` run and the launch of its ranks, the sparse optimizer and lr
schedule of the flags, the CTR data streams and the closing report.

A mesh run is one process per card, each calling the command's `main` with
the same flags (the loops step every rank on its block of the same global
batches). `join_mesh` uses the process group when one is formed already (a
caller that joined one), joins it from the environment `torchrun` sets
(`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, `LOCAL_WORLD_SIZE`),
and otherwise `spawn_ranks` starts one rank per visible card (one process
on the CPU) on a free local port, each re-running the command with that
environment, so the JAX command line's one-process `--mesh` still works.
"""
from __future__ import annotations

import functools
import importlib
import itertools
import os
import socket
import sys

import torch
import torch.distributed as dist


def add_device_flag(ap) -> None:
    ap.add_argument("--device", type=str, default="cuda",
                    help="where to train: cuda (one card, or one card a "
                         "rank with --mesh) or cpu")


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def say(*args, **kw) -> None:
    """`print` on rank 0 only."""
    if rank() == 0:
        print(*args, flush=True, **kw)


def _launched() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def needs_spawn(args) -> bool:
    """A `--mesh` run with no group to join: the command spawns its ranks."""
    return args.mesh and not dist.is_initialized() and not _launched()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(local: int, module: str, argv, n: int, port: int) -> None:
    os.environ.update(RANK=str(local), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(local), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    importlib.import_module(module).main(argv)


def spawn_ranks(module: str, argv, device: str) -> None:
    """Run `module.main(argv)` (None: this command line's arguments) in one
    spawned process per visible card (one on the CPU), joined as one group;
    returns when every rank is done and raises if one failed."""
    import torch.multiprocessing as mp
    argv = sys.argv[1:] if argv is None else argv
    n = torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1
    if n < 1:
        raise RuntimeError(f"--mesh --device {device}: no card is visible")
    mp.start_processes(_rank_main, args=(module, list(argv), n, _free_port()),
                       nprocs=n, join=True, start_method="spawn")


def join_mesh(device: str):
    """`(mesh, device, joined)`: the `("data",)` mesh over every rank of the
    process group, this rank's device, and whether this call joined the
    group (the caller then leaves it with `leave`)."""
    from ..parallel.mesh import default_mesh, init_process, mesh_device
    joined = False
    if not dist.is_initialized():
        init_process(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}",
                     int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]),
                     device=device,
                     local_size=int(os.environ["LOCAL_WORLD_SIZE"])
                     if "LOCAL_WORLD_SIZE" in os.environ else None)
        joined = True
    mesh = default_mesh(("data",), device=torch.device(device).type)
    return mesh, mesh_device(mesh), joined


def leave(joined: bool) -> None:
    if joined:
        dist.barrier()
        dist.destroy_process_group()


def sparse_opt(args, *, reg: dict, with_l2: bool = True):
    """The sparse optimizer of `--opt`, `--lr` and the regularizers in
    `reg` (`weight_decay`, `clipnorm`, `dense_grad_dtype`,
    `stochastic_rounding`); FTRL takes `--l1`, and `--weight-decay` as its
    l2 when `with_l2`."""
    from ..optim import (SparseFTRL, SparseLazyAdam, SparseRowWiseAdaGrad,
                         SparseSGD)
    if args.opt == "ftrl":
        kw = dict(lr=args.lr, l1=args.l1,
                  dense_grad_dtype=reg.get("dense_grad_dtype"))
        if with_l2:
            kw.update(l2=args.weight_decay, clipnorm=args.clipnorm)
        return SparseFTRL(**kw)
    return {"sgd": SparseSGD, "adagrad": SparseRowWiseAdaGrad,
            "adam": SparseLazyAdam}[args.opt](lr=args.lr, **reg)


def check_stochastic_rounding(ap, args, table_dtype,
                              needs="--table-dtype bfloat16") -> bool:
    """JAX's checks of `--stochastic-rounding`: not with FTRL, and only on
    bf16 tables (`needs`: the flags that make them, for the message)."""
    if not args.stochastic_rounding:
        return False
    if args.opt == "ftrl":
        ap.error("--stochastic-rounding supports sgd/adagrad/adam")
    if table_dtype != "bfloat16":
        ap.error(f"--stochastic-rounding requires {needs}")
    return True


def dense_tx(args):
    """The towers' `torch.optim` factory of `--dense-opt` (None: SGD)."""
    if args.dense_opt == "adam":
        return functools.partial(torch.optim.Adam, lr=args.lr)
    return None


def lr_schedule(args):
    """The sparse lr schedule of `--warmup-steps` and `--lr-decay`."""
    if not (args.warmup_steps or args.lr_decay != "none"):
        return None
    from ..optim import warmup_constant_lr, warmup_cosine_lr
    if args.lr_decay == "cosine":
        return warmup_cosine_lr(args.lr, args.steps, args.warmup_steps)
    return warmup_constant_lr(args.lr, args.warmup_steps)


def dtype(name):
    return None if name is None else getattr(torch, name)


def ctr_data(ap, args, vocabs, device, pool: int = 0):
    """`(train iterator, eval batches)`: the Criteo Kaggle file of
    `--criteo` (the eval batches its first `--eval-batches`, which the
    training stream skips when it evaluates; the stream cycles the file),
    else `SyntheticCriteo`. Both behind a `--prefetch`-deep host
    prefetcher; `pool > 0` cycles that many synthetic batches staged on
    `device` instead."""
    from ..data import SyntheticCriteo
    from ..io import CriteoFileLoader, PrefetchLoader
    if args.criteo:
        if args.tables != 26:
            ap.error("Criteo has 26 categorical features")
        skip = args.eval_batches if args.eval_every else 0
        train_raw = iter(CriteoFileLoader(args.criteo, vocabs, args.batch,
                                          epochs=None, skip_batches=skip))
        eval_batches = list(CriteoFileLoader(args.criteo, vocabs, args.batch,
                                             max_batches=args.eval_batches))
        return iter(PrefetchLoader(train_raw, depth=args.prefetch)), \
            eval_batches
    gen = SyntheticCriteo(vocab_sizes=vocabs, batch_size=args.batch,
                          bag=args.bag,
                          pad_idx=-1 if args.var_len_bags else None)
    eval_batches = list(gen.batches(args.eval_batches))
    if pool:
        staged = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                  for b in gen.batches(pool)]
        return itertools.cycle(staged), eval_batches
    return iter(PrefetchLoader(gen.batches(), depth=args.prefetch)), \
        eval_batches


def check_auto_shard(ap, args) -> None:
    """JAX's error on `--auto-shard` without `--mesh`."""
    if args.auto_shard and not args.mesh:
        ap.error("--auto-shard requires --mesh (the planner places tables "
                 "across mesh devices); without it the flag would be "
                 "silently ignored")


def auto_plan(args, vocabs, dim, mesh):
    """`--auto-shard`: JAX's `plan_sharding` call (hotness the bag size,
    the optimizer's state scalars a row), printed; None without it."""
    if not args.auto_shard:
        return None
    from ..parallel.planner import plan_sharding
    plan = plan_sharding(
        vocabs, dim, mesh, hotness=[float(args.bag or 1)] * args.tables,
        opt_state_scalars={"adagrad": 1, "adam": 2 * dim,
                           "ftrl": 2 * dim}.get(args.opt, 0))
    say(plan.summary())
    return plan


def device_line(device, extra: str) -> None:
    """The run's device and shape, as the JAX commands print theirs."""
    device = torch.device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    world = dist.get_world_size() if dist.is_initialized() else 1
    say(f"device={name} ranks={world} {extra}")


def report(res, evict_every: int = 0, metric: str = "AUC") -> None:
    """The closing lines: evicted rows (with `--evict-every`), examples/s,
    the last eval and the telemetry phases."""
    from ..utils.telemetry import get_telemetry
    if evict_every:
        say(f"evicted rows: {res.evicted_rows}")
    say(f"\n{res.examples_per_sec:,.0f} examples/s")
    evals = res.recalls if hasattr(res, "recalls") else res.aucs
    if evals:
        say(f"final {metric} {evals[-1][1]:.4f}")
    say("\ntelemetry:\n" + get_telemetry().summary())

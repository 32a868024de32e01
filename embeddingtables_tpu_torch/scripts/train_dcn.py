"""Train a DCN-v2 on synthetic or Criteo Kaggle data (the port of the JAX
package's `scripts/train_dcn.py`, with its flags and `--device`).

Examples:
  # Synthetic smoke run on one card
  python -m embeddingtables_tpu_torch.scripts.train_dcn --steps 200 \\
      --batch 4096

  # Criteo Kaggle (native parser + prefetch), sharded over every card
  python -m embeddingtables_tpu_torch.scripts.train_dcn \\
      --criteo /data/train.txt --mesh --steps 10000 --batch 65536 \\
      --dim 128 --ckpt /tmp/dcn_ckpt
"""
from __future__ import annotations

import argparse

from . import _common as C

MODULE = "embeddingtables_tpu_torch.scripts.train_dcn"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m " + MODULE,
        description="Train a DCN-v2 on synthetic or Criteo Kaggle data.")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=100_000)
    ap.add_argument("--tables", type=int, default=26)
    ap.add_argument("--num-cross", type=int, default=3,
                    help="cross layers (polynomial degree num_cross+1)")
    ap.add_argument("--cross-rank", type=int, default=64,
                    help="low-rank cross width; 0 = full (F, F) weights")
    ap.add_argument("--deep-mlp", type=str, default="512,256",
                    help="comma-separated deep-tower widths")
    ap.add_argument("--structure", choices=["stacked", "parallel"],
                    default="stacked")
    ap.add_argument("--criteo", type=str, default=None,
                    help="path to Criteo Kaggle train.txt (else synthetic)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard over every card (data axis), one process "
                         "a card")
    ap.add_argument("--auto-shard", action="store_true",
                    help="with --mesh: plan per-table placement and train "
                         "on it")
    ap.add_argument("--bag", type=int, default=None,
                    help="multi-hot bag size (synthetic data only)")
    ap.add_argument("--combiner", choices=["sum", "mean"], default="sum")
    ap.add_argument("--var-len-bags", action="store_true",
                    help="with --bag: variable-length bags right-padded "
                         "with the -1 sentinel (cfg.pad_idx; pads carry no "
                         "gradient)")
    ap.add_argument("--opt", choices=["sgd", "adagrad", "adam", "ftrl"],
                    default="adagrad")
    ap.add_argument("--l1", type=float, default=0.0,
                    help="FTRL l1 (trained sparsity)")
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--clipnorm", type=float, default=None)
    ap.add_argument("--evict-every", type=int, default=0,
                    help="row-lifecycle: evict stale rows every N steps")
    ap.add_argument("--evict-threshold", type=float, default=1e-3)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear lr warmup for the sparse optimizer")
    ap.add_argument("--lr-decay", choices=["none", "cosine"],
                    default="none",
                    help="sparse-lr decay after warmup (cosine to 0 at "
                         "--steps)")
    ap.add_argument("--dense-opt", choices=["sgd", "adam"],
                    default="sgd",
                    help="tower optimizer: plain SGD at --lr, or "
                         "torch.optim.Adam (replicated state on a mesh)")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--eval-metrics", action="store_true",
                    help="full CTR sweep at eval: log loss, normalized "
                         "entropy, calibration (else AUC only)")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--delta-ckpt", type=str, default=None,
                    help="incremental table checkpoints (base + touched-row "
                         "deltas, utils.deltackpt) into this dir; resumes "
                         "the tables/row state from the latest chain")
    ap.add_argument("--delta-every", type=int, default=500)
    ap.add_argument("--delta-base-every", type=int, default=8,
                    help="every Nth delta save rolls a full base")
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--table-dtype", choices=["float32", "bfloat16"],
                    default=None,
                    help="embedding-TABLE storage dtype (bf16 halves the "
                         "tables' memory; towers stay f32)")
    ap.add_argument("--stochastic-rounding", action="store_true",
                    help="with bf16 tables: stochastic rounding so sub-ulp "
                         "steps accumulate (sgd/adagrad/adam)")
    ap.add_argument("--dense-grad-dtype", choices=["float32", "bfloat16"],
                    default=None,
                    help="dense-grad scratch dtype of the stateful "
                         "optimizers (default f32, exact)")
    ap.add_argument("--prefetch", type=int, default=2)
    ap.add_argument("--device-prefetch", type=int, default=0,
                    help="copy N batches to the card ahead of the step on a "
                         "side stream (2 is a good start)")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="gradient accumulation over N slices of the batch "
                         "(one card or --mesh gather)")
    C.add_device_flag(ap)
    return ap


def main(argv=None):
    """Run the command; returns the `TrainResult` (None in the parent of a
    spawned `--mesh` run)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if C.needs_spawn(args):
        C.spawn_ranks(MODULE, argv, args.device)
        return None
    from ..models import DCNConfig, init_dcn
    from ..models.train import restore_delta, train_dcn
    from ..utils import CheckpointManager, DeltaCheckpointManager

    vocabs = tuple([args.vocab] * args.tables)
    deep = tuple(int(w) for w in args.deep_mlp.split(",") if w)
    cfg = DCNConfig(vocab_sizes=vocabs, dim=args.dim,
                    num_cross=args.num_cross,
                    cross_rank=args.cross_rank or None,
                    deep_mlp=deep, structure=args.structure,
                    bag=args.bag, combiner=args.combiner,
                    pad_idx=-1 if args.var_len_bags else None,
                    table_dtype=C.dtype(args.table_dtype))
    C.check_auto_shard(ap, args)
    mesh, plan, joined, device = None, None, False, args.device
    if args.mesh:
        mesh, device, joined = C.join_mesh(args.device)
        C.say(f"mesh: {mesh}")
        plan = C.auto_plan(args, vocabs, args.dim, mesh)
    train_it, eval_batches = C.ctr_data(ap, args, vocabs, device)

    reg = dict(weight_decay=args.weight_decay, clipnorm=args.clipnorm)
    if args.dense_grad_dtype and args.dense_grad_dtype != "float32":
        reg["dense_grad_dtype"] = args.dense_grad_dtype
    if C.check_stochastic_rounding(ap, args, args.table_dtype):
        reg["stochastic_rounding"] = True
    opt = C.sparse_opt(args, reg=reg)
    dense_tx = C.dense_tx(args)
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None
    delta_mgr = resume_model = None
    if args.delta_ckpt:
        delta_mgr = DeltaCheckpointManager(args.delta_ckpt,
                                           base_every=args.delta_base_every)
        if delta_mgr.latest_step() is not None:
            resume_model = restore_delta(delta_mgr, init_dcn(
                cfg, device=device, sparse_opt=opt, dense_tx=dense_tx))
            C.say(f"resumed tables from delta chain @ step "
                  f"{delta_mgr.latest_step()}")
    C.device_line(device, f"T={args.tables} V={args.vocab} D={args.dim} "
                          f"B={args.batch} cross={args.num_cross}x "
                          f"r={args.cross_rank}")
    res = train_dcn(cfg, train_it, args.steps, sparse_opt=opt,
                    lr_schedule=C.lr_schedule(args), model=resume_model,
                    delta_ckpt=delta_mgr, delta_every=args.delta_every,
                    dense_lr=args.lr, dense_tx=dense_tx,
                    eval_batches=eval_batches, eval_every=args.eval_every,
                    eval_metrics=args.eval_metrics, ckpt_manager=mgr,
                    ckpt_every=args.ckpt_every, log_every=args.log_every,
                    mesh=mesh, microbatch=args.microbatch, plan=plan,
                    device_prefetch=args.device_prefetch,
                    evict_every=args.evict_every,
                    evict_threshold=args.evict_threshold, device=device)
    C.report(res, args.evict_every)
    C.leave(joined)
    return res


if __name__ == "__main__":
    main()

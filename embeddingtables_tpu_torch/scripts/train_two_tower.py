"""Train a two-tower retriever on the synthetic planted-structure stream
(the port of the JAX package's `scripts/train_two_tower.py`, with its flags
and `--device`).

Examples:
  # One-card smoke run
  python -m embeddingtables_tpu_torch.scripts.train_two_tower --steps 500 \\
      --batch 256

  # Sharded over every card, larger corpus, recall@20 eval
  python -m embeddingtables_tpu_torch.scripts.train_two_tower --mesh \\
      --steps 5000 --batch 1024 --item-vocab 100000 --k 20 \\
      --ckpt /tmp/tt_ckpt
"""
from __future__ import annotations

import argparse

from . import _common as C

MODULE = "embeddingtables_tpu_torch.scripts.train_two_tower"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m " + MODULE,
        description="Train a two-tower retriever on the synthetic "
                    "planted-structure stream.")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--embed-dim", type=int, default=64)
    ap.add_argument("--item-vocab", type=int, default=10_000)
    ap.add_argument("--query-vocabs", type=int, nargs="+",
                    default=[2000, 3000])
    ap.add_argument("--num-dense", type=int, default=4)
    ap.add_argument("--mesh", action="store_true",
                    help="shard over every card (data axis), one process "
                         "a card")
    ap.add_argument("--opt", choices=["sgd", "adagrad", "adam", "ftrl"],
                    default="adagrad")
    ap.add_argument("--l1", type=float, default=0.0,
                    help="FTRL l1 (trained sparsity)")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--eval-batches", type=int, default=2)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--table-dtype", choices=["float32", "bfloat16"],
                    default=None,
                    help="embedding-TABLE storage dtype (bf16 halves the "
                         "tables' memory; MLPs stay f32)")
    ap.add_argument("--stochastic-rounding", action="store_true",
                    help="with bf16 tables: stochastic rounding so sub-ulp "
                         "steps accumulate (sgd/adagrad/adam)")
    ap.add_argument("--dense-grad-dtype", choices=["float32", "bfloat16"],
                    default=None,
                    help="dense-grad scratch dtype of the stateful "
                         "optimizers (default f32, exact)")
    ap.add_argument("--device-prefetch", type=int, default=0,
                    help="copy N batches to the card ahead of the step")
    ap.add_argument("--seed", type=int, default=0)
    C.add_device_flag(ap)
    return ap


def main(argv=None):
    """Run the command; returns the `RetrievalTrainResult` (None in the
    parent of a spawned `--mesh` run)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if C.needs_spawn(args):
        C.spawn_ranks(MODULE, argv, args.device)
        return None
    from ..data import SyntheticRetrieval
    from ..models.train import train_two_tower
    from ..models.two_tower import TwoTowerConfig
    from ..utils import CheckpointManager

    cfg = TwoTowerConfig(query_vocab_sizes=tuple(args.query_vocabs),
                         item_vocab=args.item_vocab,
                         num_dense=args.num_dense, dim=args.dim,
                         embed_dim=args.embed_dim,
                         query_mlp=(256, args.embed_dim),
                         item_mlp=(256, args.embed_dim),
                         table_dtype=C.dtype(args.table_dtype))
    gen = SyntheticRetrieval(query_vocab_sizes=cfg.query_vocab_sizes,
                             item_vocab=cfg.item_vocab,
                             num_dense=cfg.num_dense,
                             batch_size=args.batch, seed=args.seed)
    eval_batches = list(SyntheticRetrieval(
        query_vocab_sizes=cfg.query_vocab_sizes, item_vocab=cfg.item_vocab,
        num_dense=cfg.num_dense, batch_size=args.batch,
        seed=args.seed + 1000).batches(args.eval_batches))

    mesh, joined, device = None, False, args.device
    if args.mesh:
        mesh, device, joined = C.join_mesh(args.device)
        C.say(f"mesh: {mesh}")
    reg = {}
    if args.dense_grad_dtype and args.dense_grad_dtype != "float32":
        reg["dense_grad_dtype"] = args.dense_grad_dtype
    if C.check_stochastic_rounding(ap, args, args.table_dtype):
        reg["stochastic_rounding"] = True
    opt = C.sparse_opt(args, reg=reg, with_l2=False)
    mgr = CheckpointManager(args.ckpt) if args.ckpt else None

    C.device_line(device, f"qT={len(cfg.query_vocab_sizes)} "
                          f"itemV={cfg.item_vocab} D={cfg.dim} "
                          f"B={args.batch}")
    res = train_two_tower(cfg, gen.batches(), args.steps, sparse_opt=opt,
                          dense_lr=args.lr, seed=args.seed,
                          eval_batches=eval_batches,
                          eval_every=args.eval_every, k=args.k,
                          ckpt_manager=mgr, ckpt_every=args.ckpt_every,
                          log_every=args.log_every, mesh=mesh,
                          device_prefetch=args.device_prefetch,
                          device=device)
    C.report(res, metric=f"recall@{args.k}")
    C.leave(joined)
    return res


if __name__ == "__main__":
    main()

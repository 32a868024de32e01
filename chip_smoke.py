#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`embeddingtables_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card
    python3 chip_smoke.py --run-window-sweep   # only the run-scatter's L sweep
    python3 chip_smoke.py --gather-sweep       # only the gathers' R sweep
    python3 chip_smoke.py --per-table          # only the per-table comparison
    python3 chip_smoke.py --ensemble           # only the ensemble API phase
    python3 chip_smoke.py --families           # only the model-family phase
    python3 chip_smoke.py --multihot-dcn       # only its multi-hot DCN part
    python3 chip_smoke.py --variants           # only the table-variant phase
    python3 chip_smoke.py --wide-rows          # only the wide-row run-scatter
    python3 chip_smoke.py --scatter-widths     # only the run-scatter's widths
    python3 chip_smoke.py --persistence        # only the persistence phase
    python3 chip_smoke.py --microbatch         # only microbatching and dense_tx
    python3 chip_smoke.py --rpc                # only the binary RPC transport
    python3 chip_smoke.py --input-pipeline     # only the input pipeline
    python3 chip_smoke.py --mesh               # only the mesh phase, every card
    python3 chip_smoke.py --planner            # only the mesh phase's planner
    python3 chip_smoke.py --compat             # only compat, nn and the bridge
    python3 chip_smoke.py --clis               # only the training commands

Phases, each of which ends the script with a non-zero exit if it fails:

 1. The card: name and power limit (nvidia-smi), torch and CUDA versions.
 2. Build every kernel in `embeddingtables_tpu_torch/csrc/` with nvcc.
 3. Kernels: each hand-written kernel against its plain PyTorch version on
    the card (`gather_rows` bitwise; `gather_bags` within rtol 1e-6, the
    same f32 additions in the same order), then timed at the serving shape
    beside its plain version, one PyTorch library call and its bound.
 4. Serving at full width: the Criteo-shaped DLRM (26 tables x 250,000 rows
    x 128, f32 tables, bf16 towers) behind `make_dlrm_service` and
    `serve_http`, driven by 8 client threads and a few HTTP posts, with the
    `gather_rows` launch count read around the run. Scores are checked
    against the plain path (plain gather, f32 towers).
 5. Multi-hot: the same widths with bags of 8 through `gather_bags`.
 6. Update kernels: `scatter_add_rows_sorted` (SGD and row-wise AdaGrad
    epilogues, f32 and bf16 tables, padding, rows >= V, uniform and Zipf
    runs, runs placed on the kernel's window edges, n = 0) and
    `hot_accumulate` (S = 128, 384, 512, f32 and bf16 modes, out-of-range
    ids) against their plain versions; then their times beside their byte
    bounds, plain versions and one library call, the sort and permute around
    the scatter, and hot_accumulate against the scatter paths at
    S = 128 ... 1024.
 7. Stacked training at full width: `train_dlrm` on the same DLRM at
    B = 65,536 from `SyntheticCriteo`, with SparseSGD, row-wise AdaGrad
    (indexer, and auto, which takes the dense method here), bf16 tables
    with stochastic rounding, SparseLazyAdam and SparseFTRL (l1 > 0);
    run-scatter and hot_accumulate launches counted per recipe, one step of
    each optimizer held against the plain versions, per-step times with a
    kernel profile, and each recipe's peak device memory.
 8. Per-table training: 26 `SimpleEmbedding`s with the Criteo Kaggle
    cardinalities (capped at 250,000) through `lookup_vjp` and
    `ensemble_update`, counting `hot_accumulate` and run-scatter launches,
    with a kernel profile of one SGD and one AdaGrad step; then
    `hot_accumulate` checked and timed on the tiny features' own ids.
 9. The ensemble API on the same 26 tables: `maplookup` under
    `PreallocationStrategy(128)` (26 `gather_rows` launches for a list, 1
    for a `StackedTables`, bags of 8 through `gather_bags`), bitwise the
    plain path; `maplookup_vjp` + `ensemble_sgd_update(method="dedup")`
    (26 run-scatter launches a step, bitwise the plain run-scatter);
    `ensemble_update` with SparseLazyAdam and SparseFTRL (9
    `hot_accumulate` launches a step, held against the plain version); the
    six features of 250,000 rows as `SplitEmbedding`s of 65,536-row shards
    under indexer AdaGrad (4 run-scatter launches a table), against the same
    update on `SimpleEmbedding`s; and `index()` timed on the card.
10. The other model families, on the stacked training batches: DCN-v2
    (`dcn_small_config(vocab=250_000)`) and DeepFM
    (`deepfm_small_config(vocab=250_000)`, the fused (6.5M, 129) stack, and
    the unfolded layout with its (6.5M, 1) first-order stack) each trained
    by `train_dcn` / `train_deepfm` for 12 steps per recipe (run-scatter
    launches = steps x stacks, a falling loss, one step held against the
    plain versions: SGD bitwise, AdaGrad to rtol 1e-6) and served by their
    services to 8 closed-loop clients (gather launches = served batches, the
    kernel path = the plain path with f32 towers, a bag-8 batch through
    `gather_bags`); `fuse_deepfm` of the unfolded model scoring as it did;
    `gather_rows`, `gather_bags` and the run-scatter checked at D = 129 and
    D = 1 (`gather_rows` also on tables whose base is 4 or 2 bytes off the
    16-byte grid), `gather_rows` and the run-scatter timed at D = 129, 128
    and 1 and `gather_bags` at D = 129; and the two-tower retriever (1M / 100k / 1k
    query rows, 2M items, dim 64, B = 16,384) through `train_two_tower`
    (2 run-scatters a step, recall@10), `build_item_index` (31
    `gather_rows`) and `make_retrieval_service` against the plain path.
    Last, MLPerf DLRM-DCNv2 at the benchmark cell's shapes
    (`multihot_dcn_phase`: one card's share of its tables, 51.9M x 128
    f32, bags of the published per-table widths, 214 ids an example, B =
    65,536): 4 indexer-AdaGrad steps of `make_train_step` with 1
    `gather_bags_ragged`, 1 `gather_rows` and 1 run-scatter a step counted,
    the step's time, kernel profile and peak memory; `gather_bags_ragged`
    bitwise its plain version on a step's ids and timed beside it,
    `F.embedding_bag` with per-bag offsets and its byte bound.
11. The table variants. Quantized serving through
    `make_*_service(quantized=True)` to 8 closed-loop clients: the DLRM at
    int8 and int4, DCN-v2 at int8, the folded DeepFM at int8 (int4 refused
    on its D + 1 = 129 rows) and the unfolded one at int4, each within
    JAX's quantized tolerance (rtol 0.1, atol 0.05) of the f32 tables'
    scores and within rtol 1e-5 of the plain dequantize-then-f32 path, with
    its bytes and eval time beside the f32 tables'; the quantized gather
    timed against its byte bound; a bag-8 batch of the quantized DLRM beside
    its f32 reference through `gather_bags`. QR, MD and TT at one table of
    40,000,000 rows x 128 (JAX's default settings): one SGD step against the
    plain path, 4 steps at B = 65,536 on Zipf(1.1) ids with the run-scatter
    and hot_accumulate launches counted per sub-table, and the lookup timed
    beside `gather_rows` on a dense table of that size. The stacked DLRM's
    (6.5M, 128) stack in pinned host memory (`HostOffloadEmbedding`) and
    tiered after a `FrequencyTracker` relayout (hot_rows 1,024 and
    65,536): lookups bitwise a `SimpleEmbedding` on the card, updates to
    rtol 1e-6, the copies timed. `train_dlrm(evict_every=2)` with SGD and
    indexer AdaGrad for 8 steps: evicted rows > 0, those of the last
    eviction zero in the table and the accumulator.
12. Wide rows: the run-scatter at D = 258, 1,025, 2,048 and 4,096 (the
    wide class: a block a window), f32 and bf16 tables,
    SGD bitwise and AdaGrad to rtol 1e-6 against the plain version on a
    window-edge and a Zipf stream, each width timed beside its byte bound
    and `index_add_`; TT at rank 32 on the 40M-row table (a 4,096-wide
    middle core) under indexer AdaGrad, one step against the plain step
    and 4 counted steps (3 run-scatters a step). Then the run-scatter at
    every width class (`scatter_widths_phase`): D = 1, 2, 4, 7, 8, 12, 16,
    32, 36, 64, 128, 129, 258, 1,025, 2,048 and 4,096, f32 and bf16, SGD
    bitwise and AdaGrad to rtol 1e-6 against the plain version on a
    window-edge, a padded Zipf and a hot-run stream; the kernels one
    wrapper call launches (counted by the launch code) at D = 1, 258, 1,025
    and 4,096; each width timed beside its byte bound and `index_add_` on
    its path's stream, every timed set also held to the plain version.
13. Persistence on the stacked DLRM (indexer AdaGrad, B = 65,536), in a
    temporary directory checked for free space first: a delta chain (one
    base, three deltas) restored bitwise into a fresh model; a refreshable
    service following it with `DeltaFollower` and swapped under 8
    closed-loop clients (every flushed batch bitwise the old or the new
    tables' scores, the refreshed scores bitwise the trained model's);
    full checkpoints with a `DivergenceGuard` and a NaN batch (one
    rollback, bitwise the checkpoint; the next delta save a base); a
    `trace_profile` trace of one step; the folded DeepFM's (6.5M, 129)
    stack through a base, a delta, a poll and a swap. Save, restore and
    poll times and the service's latency are printed.
14. Microbatching and the towers' optimizer on the stacked DLRM (B =
    65,536): `microbatch` k = 1, 2, 4, 8 with SGD and indexer AdaGrad, and
    DCN-v2 and the folded DeepFM at k = 4, each with k + 1 `gather_rows`
    launches and one run-scatter a step, its step time and peak memory,
    one k = 4 step against the plain path (SGD bitwise, AdaGrad rtol 1e-6);
    k = 4 against k = 1 on one batch with f32 towers (within 1e-5 of the
    update); `torch.optim.Adam` towers (`dense_tx`) on the three families,
    8 steps with a falling loss, one step against the plain path, a resume
    from the step-4 checkpoint bitwise the uninterrupted run, and a guard
    rollback after a NaN batch bitwise the step-8 checkpoint, Adam state
    included.
15. The binary RPC transport: `serve_rpc` over a `ModelRouter` holding the
    f32 DLRM (f32 towers), its int8 rows and the two-tower retriever over
    2M items; 8 clients pipelining 64 requests of 1-256 examples each over
    one connection, against the same clients on the in-process batchers
    (p50 / p95 of both); every response held to the direct eval of its
    request (rtol 1e-5; retrieval ids to the plain path's); "dlrm" swapped
    under load with no request lost, each response the old or the new
    model's; `gather_rows` launches = the served f32 and retrieval batches.
16. The mesh: the sharded DLRM (26 x 250,000 x 128, B = 65,536 global,
    Zipf(1.1) batches) over every card of the machine, one rank per card
    in one NCCL group spawned from here after the build (`/dev/shm`'s size,
    the NCCL version and `nvidia-smi topo -m` first): SGD, indexer
    AdaGrad, lazy Adam and FTRL on the gather exchange and on the
    butterfly (capacity factor 2.0), 6 timed steps each with the
    collectives' CUDA-event times, the overflow, each rank's peak memory,
    the bytes each rank hands the collectives and its `gather_rows` and
    run-scatter launches (1 + 1 and 1 a step on the gather exchange, 2 + 1
    and 1 on the butterfly; 1 and 2 `gather_rows` and no run-scatter for
    Adam and FTRL); two steps of each against the single-device step (one
    rank: SGD and AdaGrad bitwise, Adam and FTRL rtol 1e-6 under
    deterministic algorithms; more ranks: rank 0 replays them unsharded,
    losses rtol 1e-5, SGD and AdaGrad tables rtol 1e-5 with atol 1e-6, and
    Adam's and FTRL's tables through the same delta's update, rtol 1e-6);
    `make_dlrm_service(mesh=)` to 4 closed-loop clients, each
    response held to the unsharded model's eval (rtol 1e-5), the other
    ranks following until the stop. Then every other family on the mesh:
    DCN-v2 and DeepFM (folded and unfolded) at the same widths and
    batches, and the two-tower model (1M / 100k / 1k query rows, 2M items,
    B = 16,384 global), SGD and indexer AdaGrad on the gather exchange,
    each with its step ms, collective ms, peak memory and launches a rank
    (required exactly); two steps of each against the single-device step
    (one card bitwise; more cards rank 0 replays them, CTR losses rtol
    1e-5 and tables rtol 1e-5 / atol 1e-6, the two-tower model losses rtol
    1e-4 and tables rtol 5e-4 / atol 1e-5); the DCN and DeepFM mesh
    services (every score the unsharded eval's) and the sharded retrieval
    service over 2M items (ids the plain retriever's); and sharded
    persistence on the DLRM: a delta chain written on the mesh restored
    into one device and one written on one device restored into the mesh
    (bitwise), a guard rollback on a NaN batch on every rank, and
    `evict_every=2` against a replayed tracker. Then the planner
    (`mesh_planner`): before the spawn, `gather_rows` at the column widths
    (500,000 rows of the two column-sharded tables, 131,072 Zipf ids, D =
    32 and 33) bitwise its plain version and timed; on the ranks, the 26
    per-feature tables (Criteo Kaggle cardinalities capped at 250,000,
    B = 65,536 global) under a three-way plan (16 replicated, 8 row-sharded,
    2 column-sharded: `plan_sharding(col_shard=...)` on more ranks, by hand
    on one, where `plan_sharding` replicates everything; the plan
    `skew_from_trackers` would choose printed beside it); the planned DLRM
    (SGD, indexer AdaGrad, lazy Adam, FTRL), DCN and folded DeepFM (SGD,
    indexer AdaGrad), each beside the uniform row-sharded step on the same
    tables (step ms, collective ms of every group's exchange, peak memory,
    launches a rank required exactly, the replicated group's bits equal
    over the ranks); two planned steps against the single-device step
    (losses rtol 1e-5, tables and towers rtol 2e-4 / atol 1e-6, the
    replicated group bitwise over the ranks after each step); the planned
    DLRM and DCN services (every score the single-device eval's, rtol
    1e-5); `train_dlrm(mesh=, plan=)` through a guard rollback on a NaN
    batch (bitwise the run without it) and `evict_every=2`. Then mixed
    dims (`mesh_mixed`): the same 26 tables, the 16 of at most 8,192 rows
    at D = 32 and the 10 larger at D = 128, placed by
    `plan_sharding_mixed` (the D = 128 group row-sharded by hand on one
    rank), `mixed_planned_lookup` and `mixed_planned_apply` with SGD and
    indexer AdaGrad against each table's single-device `lookup` (bitwise)
    and `opt.apply` (rtol 2e-5 / atol 1e-6), launches a rank by width
    required exactly. Then the planned two-tower model (`mesh_planner_tt`)
    at the two-tower shape: the 1k query table replicated, the 1M one
    row-sharded, the 100k one column-sharded and the 2M-item corpus
    row-sharded; SGD and indexer AdaGrad beside the uniform sharded step
    (launches a rank required exactly); two planned steps against the
    single-device step (losses rtol 1e-4, tables and towers rtol 5e-4 /
    atol 1e-5, the replicated group bitwise over the ranks); the planned
    index over every item against `build_item_index` (rtol 1e-5 / atol
    1e-6) and `planned_retrieve` against the plain retriever (the same ids
    as sets per row); `train_two_tower(mesh=, plan=)` with a recall eval,
    device prefetch and a checkpoint restored bitwise. Before the spawn,
    `gather_rows` at those shapes (the corpus at D = 64 by 16,384 item ids
    and by 65,536-id index chunks, the column slice at D = 16, the mixed
    replicated group at D = 32) bitwise its plain version and timed.
17. compat, nn and the torch bridge: a stock loop at B = 65,536 with
    `torch.optim.SGD` on the DLRM's towers and 26 `nn.SparseEmbed` tables
    (the Criteo Kaggle cardinalities capped at 250,000) through
    `sparse_updates_from_grads` / `apply_sparse_updates`, against the same
    steps on the plain versions; `to_torch_embedding(bag=True)` of a trained
    table (an `nn.EmbeddingBag` on the card) against its `lookup`.
18. The training commands (`embeddingtables_tpu_torch/scripts/`), each
    its own process for 20 steps (the DLRM and DCN at 26 x 250,000 x 128,
    the DeepFM and two-tower model at their flags' defaults), then
    `train_dlrm --mesh --auto-shard` on every card: each exits 0 with
    finite, falling losses. (Run before phase 19's input pipeline, which
    is last.)
19. The input pipeline: a 524,288-row Criteo-format file written by
    `io.criteo_file`, parsed natively (the library must build) bitwise
    `criteo_kaggle_batches` on the first batch, rows/s of both parsers;
    the stacked DLRM trained from `CriteoFileLoader` -> `parallel_batches`
    -> `DevicePrefetcher` for 8 steps; the same host batches at
    `device_prefetch` 0 and 2, bitwise equal, with examples/s and the idle
    share of each; `NativeSyntheticCriteo` against the numpy generator.
20. A `kernels` JSON line (every hand kernel, its launches on its paths and
    its times; the run-scatter's Zipf time beside its uniform one, the
    D = 129 times of both gathers and the run-scatter, the D = 1 times
    of `gather_rows` and the run-scatter, and the run-scatter's wide-row
    times, and `gather_rows` at the column and planned two-tower and
    mixed-dim widths; the run-scatter's times at every width of phase 12,
    its kernels per call and its launches on the paths by width class),
    the card line again, and the final JSON status line.

With `--run-window-sweep` it runs only phases 1-2 and the sweep that chose
the run-scatter's window length (`run_window_sweep`); with `--gather-sweep`
only phases 1-2 and the sweep that chose the gathers' rows in flight
(`gather_sweep`). With `--per-table` it
runs phases 1-2, `hot_accumulate`'s uniform times at S = 128 and 512, and
phase 8: the lines that compare two versions of the update kernels on the
per-table path. Copied into an unpacked older commit and run there, it
measures that commit's kernels the same way. With `--ensemble` it runs
phases 1-2 and phase 9; with `--families` phases 1-2 and phase 10 but its
multi-hot part, with `--multihot-dcn` phases 1-2, that part and its
kernel's `kernels` entry; with
`--variants` phases 1-2 and phase 11; with `--wide-rows` phases 1-2 and
phase 12's first part, with `--scatter-widths` its second; with
`--persistence` phases 1-2 and phase 13; with `--microbatch`, `--rpc`,
`--mesh`, `--compat`, `--clis` and `--input-pipeline` phases 1-2 and phase
14, 15, 16, 17, 18 or 19; with `--planner` phases 1-2 and phase 16's
planner part alone.

Without a card, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# The run-scatter's launches on the counted paths by width class (narrow,
# mid: 32-128 units, wide): every counting region below sets the wrapper's
# `classes` anew with its `launches` (`zero_scatter`) and adds them here
# when it reads the count (`scatter_count`). Mesh ranks send theirs back.
SCATTER_CLASSES = collections.Counter()


def zero_scatter(S) -> None:
    S.scatter_add_rows_sorted.launches = 0
    S.scatter_add_rows_sorted.classes = collections.Counter()


def scatter_count(S) -> int:
    SCATTER_CLASSES.update(getattr(S.scatter_add_rows_sorted, "classes", {}))
    return S.scatter_add_rows_sorted.launches


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    require(torch.equal(a.isnan(), b.isnan()), "NaN rows differ")
    return float((a.float() - b.float()).abs().nan_to_num(0.0).max())


def time_each_ms(fn, arg_sets, reps: int = 30) -> float:
    """Median device time of one call, CUDA events around each call. A sleep
    kernel queued first keeps the card behind the host, so the events time
    the device work and not the launch gaps; consecutive calls use
    different inputs, so the rows they gather are not in the L2 cache."""
    for a in arg_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    events = []
    for i in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*arg_sets[i % len(arg_sets)])
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def with_specials(ids: torch.Tensor, v: int, gen) -> torch.Tensor:
    """Turn about 1% of in-range ids into wrapped ones ([-V, 0)) and 0.1%
    into out-of-range ones (NaN rows), plus the extremes."""
    r = torch.rand(ids.shape, generator=gen, device=ids.device)
    ids = torch.where(r < 0.01, ids - v, ids)
    ids = torch.where(r > 0.999, ids + 2 * v, ids)
    flat = ids.view(-1)
    flat[:4] = torch.tensor([-v, v, 2**31 - 1, -2**31], dtype=torch.int32)
    return ids


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------

def kernel_phase(G, gen):
    v, d, n = 26 * 250_000, 128, 26 * 2048
    big32 = torch.randn((v, d), generator=gen, device="cuda")
    tables = {("float32", d): big32, ("bfloat16", d): big32.to(torch.bfloat16)}
    for dd in (64, 36):
        t = torch.randn((1_000_000, dd), generator=gen, device="cuda")
        tables[("float32", dd)] = t
        tables[("bfloat16", dd)] = t.to(torch.bfloat16)
    errs = {"gather_rows": 0.0, "gather_bags": 0.0}

    for (dt, dd), tab in tables.items():
        tv = tab.shape[0]
        sizes = (n, 26 * 65_536) if dd == d else (n,)
        for nn in sizes:
            ids = with_specials(torch.randint(0, tv, (nn,), generator=gen,
                                              device="cuda", dtype=torch.int32),
                                tv, gen)
            got, want = G.gather_rows(tab, ids), G.gather_rows_plain(tab, ids)
            torch.cuda.synchronize()
            require(torch.equal(bits(got), bits(want)),
                    f"gather_rows {dt} D={dd} n={nn} not bitwise equal")
            emit({"phase": "kernel_check", "kernel": "gather_rows",
                  "dtype": dt, "V": tv, "D": dd, "n": nn, "bitwise": True,
                  "nan_rows": int(got.isnan().any(1).sum())})
        bags = (1, 8, 32) if dd == d else ((8,) if dd == 36 else ())
        for bag in bags:
            ids = with_specials(torch.randint(0, tv, (n, bag), generator=gen,
                                              device="cuda", dtype=torch.int32),
                                tv, gen)
            got, want = G.gather_bags(tab, ids), G.gather_bags_plain(tab, ids)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=1e-6,
                                       atol=0.0, equal_nan=True)
            err = max_abs_err(got, want)
            errs["gather_bags"] = max(errs["gather_bags"], err)
            emit({"phase": "kernel_check", "kernel": "gather_bags",
                  "dtype": dt, "V": tv, "D": dd, "n": n, "bag": bag,
                  "max_abs_err": err, "rtol": 1e-6})

    # Times at the serving shape: B = 2048 one-hot (n = 26 * 2048 ids) and the
    # bag-8 multi-hot path, f32 table. Ten id sets, in range (the library
    # calls assert on out-of-range ids).
    F = torch.nn.functional
    itemsize = big32.element_size()
    timings = {}
    for name, bag in (("gather_rows", None), ("gather_bags", 8)):
        shape = (n,) if bag is None else (n, bag)
        sets = [torch.randint(0, v, shape, generator=gen, device="cuda",
                              dtype=torch.int32) for _ in range(10)]
        longs = [s.long() for s in sets]
        uniq = statistics.mean(torch.unique(s).numel() for s in sets)
        nbytes = uniq * d * itemsize + sets[0].numel() * 4 + n * d * itemsize
        ops = 0 if bag is None else n * bag * d
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = ops / F32_OPS_PER_S * 1e3
        kern = getattr(G, name)
        plain = getattr(G, name + "_plain")
        if bag is None:
            lib = lambda ids: F.embedding(ids, big32)  # noqa: E731
        else:
            lib = lambda ids: F.embedding_bag(ids, big32, mode="sum")  # noqa: E731
        before = kern.launches
        t = {"kernel_ms": time_each_ms(lambda i: kern(big32, i), [(s,) for s in sets]),
             "plain_ms": time_each_ms(lambda i: plain(big32, i), [(s,) for s in sets]),
             "library_ms": time_each_ms(lib, [(s,) for s in longs]),
             "bound_ms": max(bound_bytes_ms, bound_ops_ms),
             "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"}
        timings[name] = t
        emit({"phase": "kernel_time", "kernel": name, "dtype": "float32",
              "V": v, "D": d, "n": n, "bag": bag, "bytes": nbytes,
              "unique_rows": uniq, **t,
              "launches_in_phase": kern.launches - before})

    # The bench.py batch (26 x 65,536 ids) for gather_rows, beside the library.
    nb = 26 * 65_536
    sets = [torch.randint(0, v, (nb,), generator=gen, device="cuda",
                          dtype=torch.int32) for _ in range(3)]
    uniq = statistics.mean(torch.unique(s).numel() for s in sets)
    emit({"phase": "kernel_time", "kernel": "gather_rows", "dtype": "float32",
          "V": v, "D": d, "n": nb,
          "kernel_ms": time_each_ms(lambda i: G.gather_rows(big32, i),
                                    [(s,) for s in sets], reps=20),
          "library_ms": time_each_ms(lambda i: F.embedding(i, big32),
                                     [(s.long(),) for s in sets], reps=20),
          "bound_ms": (uniq + nb) * d * itemsize / HBM_BYTES_PER_S * 1e3
          + nb * 4 / HBM_BYTES_PER_S * 1e3})
    return errs, timings


# ---------------------------------------------------------------------------
# Phase 4: the DLRM service at full width
# ---------------------------------------------------------------------------

def make_request(rng, cfg, b, bag=None):
    shape = (b,) if bag is None else (b, bag)
    dense = rng.standard_normal((b, cfg.num_dense)).astype(np.float32)
    cat = np.stack([rng.integers(0, v, shape) for v in cfg.vocab_sizes])
    return dense, cat.astype(np.int32)


def plain_logits(model, cfg, dense, cat):
    """The plain path on the card: plain gathers, then the towers of `cfg`."""
    from embeddingtables_tpu_torch.models.dlrm import (forward_from_embeddings,
                                                      stacked_flat_indices)
    from embeddingtables_tpu_torch.ops.cuda import gather as G
    with torch.inference_mode():
        flat, _ = stacked_flat_indices(model.tables, torch.from_numpy(cat))
        data = model.tables.data
        rows = (G.gather_rows_plain(data, flat) if flat.dim() == 1
                else G.gather_bags_plain(data, flat))
        emb = rows.reshape(cfg.num_tables, dense.shape[0], cfg.dim)
        return forward_from_embeddings(model.bottom, model.top, cfg,
                                       torch.from_numpy(dense).to(data.device),
                                       emb)


def serving_phase(ett, G, model, cfg):
    svc = ett.make_dlrm_service(model, max_batch=2048, max_latency_ms=2.0)
    server = ett.serve_http(svc)
    port = server.server_address[1]
    served = []                     # (dense, cat, scores, latency_s)
    lock = threading.Lock()
    try:
        warm = np.random.default_rng(SEED + 99)
        for b in (1, 256, 2048):
            svc.predict(*make_request(warm, cfg, b), timeout=300)

        def client(k):
            rng = np.random.default_rng(SEED + 1000 + k)
            for _ in range(30):
                dense, cat = make_request(rng, cfg, int(rng.integers(1, 257)))
                t0 = time.perf_counter()
                scores = svc.predict(dense, cat, timeout=300)
                lat = time.perf_counter() - t0
                with lock:
                    served.append((dense, cat, scores, lat))

        def http_post(k):
            dense, cat = make_request(np.random.default_rng(SEED + 2000 + k),
                                      cfg, 4)
            body = json.dumps({"dense": dense.tolist(),
                               "cat": cat.tolist()}).encode()
            r = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=body,
                headers={"Content-Type": "application/json"}), timeout=300)
            return np.asarray(json.loads(r.read())["scores"], np.float32)

        batches_before = svc.stats_snapshot()["batches"]
        G.gather_rows.launches = 0
        G.gather_bags.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=12) as pool:
            futs = [pool.submit(client, k) for k in range(8)]
            futs += [pool.submit(http_post, k) for k in range(4)]
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        launches = {"gather_rows": G.gather_rows.launches,
                    "gather_bags": G.gather_bags.launches}
        stats = svc.stats_snapshot()
        batches = stats["batches"] - batches_before
        http_scores = results[8:]
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()

    require(len(served) == 240 and all(s.shape == (4,) for s in http_scores),
            "not every request was answered")
    require(all(np.isfinite(s[2]).all() and s[2].shape == (s[0].shape[0],)
                for s in served) and all(np.isfinite(s).all()
                                         for s in http_scores),
            "non-finite or misshapen scores")
    require(launches["gather_rows"] == batches > 0,
            f"gather_rows launches {launches['gather_rows']} != served "
            f"batches {batches}")
    lat_ms = sorted(1e3 * s[3] for s in served)
    emit({"phase": "serve", "requests": len(served) + len(http_scores),
          "examples": sum(s[0].shape[0] for s in served) + 16,
          "wall_s": wall, "batches": batches,
          "latency_samples": len(lat_ms),
          "latency_ms_p50": float(np.percentile(lat_ms, 50)),
          "latency_ms_p95": float(np.percentile(lat_ms, 95)),
          "latency_ms_p99": float(np.percentile(lat_ms, 99)),
          "launches": launches, "batcher_stats": stats})

    # Held against the plain path on the card (outside the counted run).
    sample = served[:16]
    dense = np.concatenate([s[0] for s in sample])
    cat = np.concatenate([s[1] for s in sample], axis=1)
    service = np.concatenate([s[2] for s in sample])
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    model32 = ett.DLRM(cfg32, model.bottom, model.top, model.tables)
    ref = plain_logits(model, cfg32, dense, cat)
    kern32 = ett.make_eval_step(cfg32)(model32, dense, cat)
    torch.testing.assert_close(kern32, ref, rtol=1e-5, atol=1e-6)
    ref = ref.cpu().numpy()
    # bf16 towers against f32 towers: every tower op rounds to bf16 (2^-9
    # relative), compounding over nine layers and the interaction; held to
    # 2^-4 of the largest reference logit.
    bf16_err = float(np.abs(service - ref).max())
    bf16_tol = 2 ** -4 * float(np.abs(ref).max())
    require(bf16_err <= bf16_tol, f"bf16 service error {bf16_err} > {bf16_tol}")
    emit({"phase": "serve_check", "examples": int(dense.shape[0]),
          "kernel_f32_vs_plain_f32_max_abs": float(
              np.abs(kern32.cpu().numpy() - ref).max()),
          "service_bf16_vs_plain_f32_max_abs": bf16_err,
          "bf16_tolerance": bf16_tol,
          "max_abs_logit": float(np.abs(ref).max())})
    return launches


def throughput(ett, model, cfg, bag=None, b=2048, steps=20):
    """Examples/s of the eval step at batch b: CUDA events over `steps`
    back-to-back forwards on device-resident inputs."""
    rng = np.random.default_rng(SEED + 3)
    dense, cat = make_request(rng, cfg, b, bag)
    dense, cat = torch.from_numpy(dense).cuda(), torch.from_numpy(cat).cuda()
    step = ett.make_eval_step(cfg)
    for _ in range(3):
        step(model, dense, cat)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        out = step(model, dense, cat)
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    ms = start.elapsed_time(end) / steps
    require(bool(torch.isfinite(out).all()), "non-finite logits")

    emit({"phase": "forward_time", "bag": bag, "batch": b,
          "forward_ms": ms, "host_wall_ms": wall,
          "examples_per_s": b / (ms / 1e3),
          **kernel_profile(lambda: step(model, dense, cat), ms)})


# The hand kernels' device-function names, as the profiler shows them.
HAND_KERNELS = {"scatter_add_rows_sorted": "runscatter_",
                "hot_accumulate": "segsum_", "gather_rows": "gather_rows_",
                "gather_bags": "gather_bags_"}


def kernel_profile(fn, step_ms: float, reps: int = 5,
                   hand: dict = HAND_KERNELS) -> dict:
    """Kernel time per call of `fn` by name (torch.profiler over `reps`
    calls), the time of each of the `hand` kernels (wrapper -> a part of
    its device functions' names), and the device's idle share of a
    `step_ms` step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # Kernel events only: an aten op's device time repeats its kernels'.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in kernels) / reps
    return {"profiled_kernel_us_per_step": device_us,
            "device_idle_share": 1.0 - device_us / (step_ms * 1e3),
            "kernels_per_step": sum(e.count for e in kernels) / reps,
            "hand_kernel_us_per_step": {
                name: sum(e.self_device_time_total for e in kernels
                          if key in e.key) / reps
                for name, key in hand.items()},
            "top_kernels_us_per_step": [
                [e.key[:70], e.self_device_time_total / reps]
                for e in kernels[:8]]}


# ---------------------------------------------------------------------------
# Phase 5: multi-hot through gather_bags
# ---------------------------------------------------------------------------

def multihot_phase(ett, G, model, cfg):
    cfgb = dataclasses.replace(cfg, bag=8)
    modelb = ett.DLRM(cfgb, model.bottom, model.top, model.tables)
    step = ett.make_eval_step(cfgb)
    rng = np.random.default_rng(SEED + 4)
    reqs = [make_request(rng, cfgb, 2048, 8) for _ in range(4)]
    G.gather_rows.launches = 0
    G.gather_bags.launches = 0
    outs = [step(modelb, d, c) for d, c in reqs]
    torch.cuda.synchronize()
    launches = {"gather_rows": G.gather_rows.launches,
                "gather_bags": G.gather_bags.launches}
    require(launches["gather_bags"] == len(reqs)
            and launches["gather_rows"] == 0,
            f"multi-hot launches {launches}")
    require(all(bool(torch.isfinite(o).all()) for o in outs),
            "non-finite multi-hot logits")
    ref = plain_logits(modelb, cfgb, *reqs[0])
    torch.testing.assert_close(outs[0], ref, rtol=1e-5, atol=1e-6)
    emit({"phase": "multihot", "batches": len(reqs), "batch": 2048, "bag": 8,
          "launches": launches,
          "kernel_vs_plain_max_abs": float((outs[0] - ref).abs().max())})
    return launches, modelb, cfgb


# ---------------------------------------------------------------------------
# Phase 6: the update kernels against their plain versions, and their times
# ---------------------------------------------------------------------------

B_TRAIN = 65_536                   # bench.py's single-chip batch
VOCAB = 250_000                    # the serving model's rows per table
SHARD_ROWS = 65_536                # the ensemble phase's SplitEmbedding shards
# The two-tower retriever: query and item rows, its batch and eval batches.
TT_QUERY_VOCABS = (1_000_000, 100_000, 1_000)
TT_ITEMS = 2_000_000
TT_BATCH = 16_384
TT_EVAL_BATCH = 1024
# Criteo Kaggle (Display Advertising Challenge) per-feature cardinalities, as
# facebookresearch/dlrm lists them for the Kaggle data set.
CRITEO_KAGGLE_CARDINALITIES = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)


def criteo_batches(ett, vocab_sizes, k: int, seed: int):
    """k `SyntheticCriteo` batches of B_TRAIN (Zipf(1.1) ids), made on the
    host and moved to the card."""
    data = ett.SyntheticCriteo(vocab_sizes=vocab_sizes, batch_size=B_TRAIN,
                               seed=seed)
    return [{key: torch.from_numpy(v).cuda() for key, v in b.items()}
            for b in data.batches(k)]


def stacked_rows(batch, vocab: int) -> torch.Tensor:
    """A (T, B) batch's ids as rows of the stacked (T * vocab, D) table."""
    cat = batch["cat"]
    starts = torch.arange(cat.shape[0], device=cat.device,
                          dtype=torch.int32) * vocab
    return (cat + starts[:, None]).reshape(-1)


def with_padding(rows: torch.Tensor, v: int, gen) -> torch.Tensor:
    """About 1% of the ids made padding (-1) and 0.5% rows >= V, sorted."""
    r = torch.rand(rows.shape, generator=gen, device="cuda")
    rows = torch.where(r < 0.01, -1, rows)
    rows = torch.where(r > 0.995, v + 3, rows)
    return torch.sort(rows.to(torch.int32), stable=True).values


def window_edge_stream(window: int, v: int, reps: int = 200) -> torch.Tensor:
    """Sorted rows whose runs sit on the run-scatter's window edges (length
    L), `reps` times over: each repetition (10 windows) has runs of L and
    L + 1, a run starting at L - 1 (mod L) and spanning five windows, a run
    filling one window exactly, and short runs. Padding comes first (L / 4
    positions, before the first edge) and 20 rows >= V last."""
    pad = window // 4
    lengths = [pad, window, window + 1, window - 2 - pad, 3 * window + 5,
               window - 4, window, 1, 2, 3, window + 1, 7, window - 14]
    runs = len(lengths) * reps
    ids = torch.arange(runs, device="cuda", dtype=torch.int32) * (v // runs)
    ids[0] = -1
    counts = torch.tensor(lengths * reps, device="cuda")
    rows = torch.repeat_interleave(ids, counts)
    return torch.cat([rows, torch.full((20,), v, dtype=torch.int32,
                                       device="cuda")])


def scatter_agrees(tk, tp, ak, ap, what: str) -> float:
    """Holds a run-scatter's table tk (and accumulator ak, AdaGrad) to the
    plain version's tp (ap): SGD bitwise, AdaGrad to rtol 1e-6 (2^-7 on a
    bf16 table). Returns the max abs error."""
    torch.cuda.synchronize()
    if ak is not None:
        rtol = 1e-6 if tk.dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(tk.float(), tp.float(), rtol=rtol,
                                   atol=1e-6, msg=lambda m: f"{what}: {m}")
        torch.testing.assert_close(ak, ap, rtol=1e-6, atol=0.0,
                                   msg=lambda m: f"{what}: {m}")
    else:
        require(torch.equal(bits(tk), bits(tp)), f"{what} not bitwise")
    return max_abs_err(tk, tp)


def check_scatter(S, gen, streams, v, d):
    """scatter_add_rows_sorted against its plain version at the training
    shape, on sorted streams: SGD bitwise, AdaGrad to rtol 1e-6 (the mean's
    reduction order, rsqrt's last bits; one bf16 rounding, 2^-7 relative, on
    bf16 tables)."""
    err = 0.0
    table32 = torch.randn((v, d), generator=gen, device="cuda") * 0.05
    accum0 = torch.rand((v,), generator=gen, device="cuda")
    for kind, rows in streams.items():
        vals = torch.randn((rows.numel(), d), generator=gen, device="cuda")
        valid = rows[(rows >= 0) & (rows < v)]
        longest = int(torch.unique_consecutive(
            valid, return_counts=True)[1].max())
        for dtype in (torch.float32, torch.bfloat16):
            base = table32.to(dtype)
            for adagrad in (False, True):
                tk, tp = base.clone(), base.clone()
                ak = accum0.clone() if adagrad else None
                ap = accum0.clone() if adagrad else None
                S.scatter_add_rows_sorted(tk, rows, vals, -1e-3, accum=ak,
                                          eps=1e-8)
                S.scatter_add_rows_sorted_plain(tp, rows, vals, -1e-3,
                                                accum=ap, eps=1e-8)
                e = scatter_agrees(tk, tp, ak, ap, f"scatter {kind} {dtype}")
                err = max(err, e)
                emit({"phase": "kernel_check",
                      "kernel": "scatter_add_rows_sorted", "stream": kind,
                      "epilogue": "adagrad" if adagrad else "sgd",
                      "dtype": str(dtype).split(".")[1], "V": v, "D": d,
                      "n": rows.numel(), "longest_run": longest,
                      "max_abs_err": e,
                      "tolerance": "bitwise" if not adagrad else
                      ("rtol 1e-6" if dtype == torch.float32 else "rtol 2^-7")})
                del tk, tp
    small = torch.ones((10, d), device="cuda")
    before = S.scatter_add_rows_sorted.launches
    S.scatter_add_rows_sorted(small, torch.zeros(0, dtype=torch.int32,
                                                 device="cuda"),
                              torch.zeros((0, d), device="cuda"))
    require(torch.equal(small, torch.ones_like(small))
            and S.scatter_add_rows_sorted.launches == before,
            "an empty stream changed the table or launched")
    emit({"phase": "kernel_check", "kernel": "scatter_add_rows_sorted",
          "n": 0, "unchanged": True, "launched": False})
    return err


def check_hot_accumulate(H, gen, d=128, n=B_TRAIN):
    """hot_accumulate against its plain version: the atomics add in a varying
    order, so the error is held to 1e-5 of the summed magnitude."""
    err = 0.0
    for segments in (128, 384, 512):
        rows = torch.randint(-10, segments + 50, (n,), generator=gen,
                             device="cuda", dtype=torch.int32)
        vals = torch.randn((n, d), generator=gen, device="cuda")
        for compute in (torch.float32, torch.bfloat16):
            got = H.hot_accumulate(rows, vals, segments, compute_dtype=compute)
            want = H.hot_accumulate_plain(rows, vals, segments, compute)
            mag = H.hot_accumulate_plain(rows, vals.abs(), segments, compute)
            require(bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all()),
                    f"hot_accumulate S={segments} {compute}")
            e = max_abs_err(got, want)
            err = max(err, e)
            emit({"phase": "kernel_check", "kernel": "hot_accumulate",
                  "segments": segments, "D": d, "n": n,
                  "compute": str(compute).split(".")[1], "max_abs_err": e,
                  "tolerance": "1e-5 of sum |vals| per segment"})
    return err


def time_scatter(S, G, gen, sets, v, d, label):
    """The run-scatter (SGD epilogue) at one shape, f32 table: its time, the
    sort and permute that scatter_update puts before it, the plain version,
    `index_add_` as the yardstick, and the byte bound
    n*D*4 (values) + n*4 (rows) + 2*U*D*4 (one read, one write per row)."""
    table = torch.randn((v, d), generator=gen, device="cuda") * 0.05
    prepared = []
    for rows in sets:
        srows, perm = torch.sort(rows, stable=True)
        vals = torch.randn((rows.numel(), d), generator=gen, device="cuda")
        prepared.append((rows, vals, srows, perm.to(torch.int32),
                         G.gather_rows(vals, perm.to(torch.int32))))
    n = sets[0].numel()
    uniq = statistics.mean(int(torch.unique(r).numel()) for r in sets)
    longest = max(int(torch.unique_consecutive(p[2], return_counts=True)[1]
                      .max()) for p in prepared)
    nbytes = n * d * 4 + n * 4 + 2 * uniq * d * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = (n * d + 2 * uniq * d) / F32_OPS_PER_S * 1e3
    plain_reps = 3 if longest > 1000 else 10
    t = {"kernel_ms": time_each_ms(
            lambda r, x: S.scatter_add_rows_sorted(table, r, x, -1e-4),
            [(p[2], p[4]) for p in prepared]),
         "plain_ms": time_each_ms(
            lambda r, x: S.scatter_add_rows_sorted_plain(table, r, x, -1e-4),
            [(p[2], p[4]) for p in prepared], reps=plain_reps),
         "library_ms": time_each_ms(
            lambda r, x: table.index_add_(0, r, x, alpha=-1e-4),
            [(p[2].long(), p[4]) for p in prepared]),
         "bound_ms": max(bound_bytes_ms, bound_ops_ms),
         "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"}
    extra = {"sort_ms": time_each_ms(lambda r: torch.sort(r, stable=True),
                                     [(p[0],) for p in prepared]),
             "permute_ms": time_each_ms(G.gather_rows,
                                        [(p[1], p[3]) for p in prepared]),
             "adagrad_kernel_ms": time_each_ms(
                 lambda r, x, a: S.scatter_add_rows_sorted(
                     table, r, x, -1e-4, accum=a, eps=1e-8),
                 [(p[2], p[4], torch.zeros(v, device="cuda"))
                  for p in prepared[:1]])}
    emit({"phase": "kernel_time", "kernel": "scatter_add_rows_sorted",
          "stream": label, "dtype": "float32", "V": v, "D": d, "n": n,
          "unique_rows": uniq, "longest_run": longest, "bytes": nbytes,
          **t, **extra})
    return t


def time_hot_accumulate(H, gen, segments, d=128, n=B_TRAIN):
    """hot_accumulate (f32, as `_dense_grad` calls it) beside its plain
    version, `torch.zeros(S, D).index_add_` and its byte bound
    n*(4*D + 4) + S*D*4."""
    sets = [(torch.randint(0, segments, (n,), generator=gen, device="cuda",
                           dtype=torch.int32),
             torch.randn((n, d), generator=gen, device="cuda"))
            for _ in range(3)]
    nbytes = n * (4 * d + 4) + segments * d * 4
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = n * d / F32_OPS_PER_S * 1e3
    f32 = torch.float32
    t = {"kernel_ms": time_each_ms(
            lambda r, x: H.hot_accumulate(r, x, segments, compute_dtype=f32),
            sets),
         "plain_ms": time_each_ms(
            lambda r, x: H.hot_accumulate_plain(r, x, segments, f32), sets),
         "library_ms": time_each_ms(
            lambda r, x: torch.zeros((segments, d), device="cuda")
            .index_add_(0, r, x), [(r.long(), x) for r, x in sets]),
         "bound_ms": max(bound_bytes_ms, bound_ops_ms),
         "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"}
    emit({"phase": "kernel_time", "kernel": "hot_accumulate",
          "segments": segments, "D": d, "n": n, "bytes": nbytes, **t})
    return t, sets


def segsum_crossover(S, H, gen, d=128, n=B_TRAIN):
    """The data for `_SEGSUM_MAX_VPAD` on this card: per padded vocab S,
    hot_accumulate (the dense gradient of tiny tables) against the scratch
    `index_add_` (`_dense_grad`'s other branch) and the run-scatter path of
    unregularized SGD (sort, permute, scatter) on an (S, D) table."""
    out = []
    for segments in (128, 256, 384, 512, 640, 768, 896, 1024):
        sets = [(torch.randint(0, segments, (n,), generator=gen,
                               device="cuda", dtype=torch.int32),
                 torch.randn((n, d), generator=gen, device="cuda"))
                for _ in range(3)]
        table = torch.zeros((segments, d), device="cuda")
        row = {"segments": segments,
               "hot_accumulate_ms": time_each_ms(
                   lambda r, x: H.hot_accumulate(
                       r, x, segments, compute_dtype=torch.float32), sets),
               "scratch_index_add_ms": time_each_ms(
                   lambda r, x: torch.zeros((segments + 1, d), device="cuda")
                   .index_add_(0, r, x), [(r.long(), x) for r, x in sets]),
               "run_scatter_path_ms": time_each_ms(
                   lambda r, x: S.scatter_update(table, r, x, -1e-4), sets)}
        out.append(row)
    emit({"phase": "segsum_crossover", "n": n, "D": d, "rows": out})


def update_kernel_phase(ett, S, H, G, gen):
    t0 = time.perf_counter()
    v, d, t = 26 * VOCAB, 128, 26
    zipf = [stacked_rows(b, VOCAB) for b in
            criteo_batches(ett, (VOCAB,) * t, 3, SEED + 5)]
    uniform = [torch.randint(0, v, (t * B_TRAIN,), generator=gen,
                             device="cuda", dtype=torch.int32)
               for _ in range(3)]
    edges = window_edge_stream(S.RUN_WINDOW, v)
    errs = {"scatter_add_rows_sorted": check_scatter(
                S, gen, {"uniform": with_padding(uniform[0], v, gen),
                         "zipf": with_padding(zipf[0], v, gen),
                         "window_edges": edges}, v, d),
            "hot_accumulate": check_hot_accumulate(H, gen)}
    emit({"phase": "update_kernel_checks",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    timings = {"scatter_add_rows_sorted": time_scatter(S, G, gen, uniform, v,
                                                       d, "uniform")}
    # Zipf is the training path's traffic: its time joins the kernels line.
    z = time_scatter(S, G, gen, zipf, v, d, "zipf")
    timings["scatter_add_rows_sorted"].update(zipf_ms=z["kernel_ms"],
                                              zipf_bound_ms=z["bound_ms"])
    time_scatter(S, G, gen, [u[:t * 2048] for u in uniform], v, d,
                 "uniform_serving_batch")
    del zipf, uniform
    timings["hot_accumulate"], _ = time_hot_accumulate(H, gen, 128)
    time_hot_accumulate(H, gen, 512)
    segsum_crossover(S, H, gen)
    torch.cuda.empty_cache()
    emit({"phase": "update_kernel_times",
          "seconds": time.perf_counter() - t0})
    return errs, timings


def run_window_sweep(ett, S, gen, windows=(128, 256, 512, 1024)):
    """How the run-scatter's window length L was chosen: the kernel built
    with each L in `windows` (scatter.cu's kRunWindow replaced in a copy),
    checked bitwise against the plain version summing in the same windows
    (SGD, f32, stacked Zipf stream), and timed on the stacked uniform and
    Zipf streams and on the per-table path's run-scatter inputs (the 17
    Criteo features over 512 padded rows, one call each, summed per step).
    Run with `python3 chip_smoke.py --run-window-sweep`."""
    import ctypes
    from embeddingtables_tpu_torch import config
    from embeddingtables_tpu_torch.ops.cuda import _lib
    src = (_lib.CSRC / "scatter.cu").read_text()
    line = f"constexpr int kRunWindow = {S.RUN_WINDOW};"
    require(line in src, "scatter.cu does not declare kRunWindow as expected")
    out = config.KERNEL_BUILD_DIR / "run_window_sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for w in windows:
        cu, so = out / f"scatter_L{w}.cu", out / f"scatter_L{w}.so"
        cu.write_text(src.replace(line, f"constexpr int kRunWindow = {w};"))
        procs[w] = (so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for w, (so, proc) in procs.items():
        log, _ = proc.communicate()
        require(proc.returncode == 0, f"nvcc with L = {w}:\n{log}")
        fn = ctypes.CDLL(str(so)).et_scatter_add_rows_sorted
        fn.argtypes = S._SIGNATURES["et_scatter_add_rows_sorted"]
        fn.restype = ctypes.c_int
        libs[w] = fn

    def scatter(w, table, rows, vals):
        (n,), (v, d) = rows.shape, table.shape
        scratch = torch.empty((2 * -(-n // w), d), device="cuda")
        err = libs[w](table.data_ptr(), rows.data_ptr(), vals.data_ptr(),
                      None, scratch.data_ptr(), None, n, v, d, 0, -1e-4, 0.0,
                      _lib.stream_of(table), None)
        require(err == 0, f"run-scatter with L = {w}: CUDA error {err}")

    def sorted_sets(row_sets):
        return [(torch.sort(r.to(torch.int32)).values,
                 torch.randn((r.numel(), 128), generator=gen, device="cuda"))
                for r in row_sets]

    v = 26 * VOCAB
    stacked = {
        "uniform": sorted_sets(torch.randint(0, v, (26 * B_TRAIN,),
                                             generator=gen, device="cuda")
                               for _ in range(3)),
        "zipf": sorted_sets(stacked_rows(b, VOCAB) for b in criteo_batches(
            ett, (VOCAB,) * 26, 3, SEED + 5))}
    table = torch.randn((v, 128), generator=gen, device="cuda") * 0.05
    vocabs = tuple(min(c, VOCAB) for c in CRITEO_KAGGLE_CARDINALITIES)
    (batch,) = criteo_batches(ett, vocabs, 1, SEED + 7)
    per_table = [(torch.zeros((vv, 128), device="cuda"), *sorted_sets(
        [batch["cat"][j]])[0]) for j, vv in enumerate(vocabs)
        if -(-vv // 128) * 128 > 512]
    results = []
    for w in windows:
        rows, vals = stacked["zipf"][0]
        tk, tp = table.clone(), table.clone()
        scatter(w, tk, rows, vals)
        saved, S.RUN_WINDOW = S.RUN_WINDOW, w
        try:
            S.scatter_add_rows_sorted_plain(tp, rows, vals, -1e-4)
        finally:
            S.RUN_WINDOW = saved
        torch.cuda.synchronize()
        require(torch.equal(bits(tk), bits(tp)), f"L = {w}: not bitwise")
        del tk, tp
        row = {"window": w, "zipf_bitwise": True}
        for kind, sets in stacked.items():
            row[f"{kind}_ms"] = time_each_ms(
                lambda r, x: scatter(w, table, r, x), sets)
        row["per_table_sgd_ms_per_step"] = time_each_ms(
            lambda: [scatter(w, *p) for p in per_table], [()], reps=10)
        results.append(row)
    emit({"phase": "run_window_sweep", "n_stacked": 26 * B_TRAIN,
          "per_table_calls": len(per_table), "chosen": S.RUN_WINDOW,
          "rows": results})


def gather_bound_ms(sets, d: int, itemsize: int = 4) -> float:
    """The byte bound of a gather or bag-sum over `sets` (one id set a
    call): each unique row read once, the ids read once, the output
    written once. A bag-sum's adds (n * bag * D) are far below the f32
    rate, so bytes bound both."""
    ids = sets[0]
    uniq = statistics.mean(int(torch.unique(s).numel()) for s in sets)
    rows = ids.shape[0]
    return (uniq * d * itemsize + ids.numel() * 4 + rows * d * itemsize) \
        / HBM_BYTES_PER_S * 1e3


def gather_sweep(ett, G, gen, rows_in_flight=(1, 2, 4, 8),
                 grid_vec_min_bytes=(0, 1 << 40)):
    """How `gather.cu`'s rows in flight R, and which rows on the 16-byte grid
    take the vector kernel, were chosen: the source built with each R in
    `rows_in_flight` (its kRowsInFlight replaced in a copy), and with the
    built R and each grid threshold in `grid_vec_min_bytes` (its
    kGridVecMinBytes: 0 sends every grid row to the vector kernel, 2^40
    none); each build checked bitwise against the plain versions, then timed
    on the training path's Zipf ids (n = 1,703,936) at D = 129, 128 and 1
    (f32 and bf16), at the serving shape (n = 53,248 uniform ids) at D = 128,
    64 and 36, and as bag-8 sums at D = 129 and 128, beside `F.embedding` /
    `F.embedding_bag` and the byte bounds. A source that declares neither
    constant (an older commit) is built and timed as it is. Run with
    `python3 chip_smoke.py --gather-sweep`."""
    import ctypes
    import re
    from embeddingtables_tpu_torch import config
    from embeddingtables_tpu_torch.ops.cuda import _lib
    F = torch.nn.functional
    src = (_lib.CSRC / "gather.cu").read_text()
    r_line = re.compile(r"constexpr int kRowsInFlight = (\d+);")
    g_line = re.compile(r"constexpr int64_t kGridVecMinBytes = (\d+);")
    built = {"rows_in_flight": None, "grid_vec_min_bytes": None}
    variants = {}
    if r_line.search(src) and g_line.search(src):
        r0 = int(r_line.search(src).group(1))
        g0 = int(g_line.search(src).group(1))
        built = {"rows_in_flight": r0, "grid_vec_min_bytes": g0}
        for r, g in [(r, g0) for r in rows_in_flight] + [
                (r0, g) for g in grid_vec_min_bytes]:
            variants[(r, g)] = g_line.sub(
                f"constexpr int64_t kGridVecMinBytes = {g};",
                r_line.sub(f"constexpr int kRowsInFlight = {r};", src))
    else:
        variants[(None, None)] = src
    out = config.KERNEL_BUILD_DIR / "gather_sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for (r, g), text in variants.items():
        cu, so = out / f"gather_R{r}_G{g}.cu", out / f"gather_R{r}_G{g}.so"
        if so.exists() and cu.read_text() == text:
            procs[(r, g)] = (so, None)
            continue
        cu.write_text(text)
        procs[(r, g)] = (so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        if proc is not None:
            log, _ = proc.communicate()
            require(proc.returncode == 0, f"nvcc for {key}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in G._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib

    def rows(lib, table, ids):
        (n,), (v, d) = ids.shape, table.shape
        o = torch.empty((n, d), dtype=table.dtype, device="cuda")
        err = lib.et_gather_rows(table.data_ptr(), ids.data_ptr(), o.data_ptr(),
                                 n, v, d, G._DTYPE_CODE[table.dtype],
                                 _lib.sm_count(table), _lib.stream_of(table))
        require(err == 0, f"gather_rows: CUDA error {err}")
        return o

    def bags(lib, table, ids):
        (n, bag), (v, d) = ids.shape, table.shape
        o = torch.empty((n, d), dtype=table.dtype, device="cuda")
        err = lib.et_gather_bags(table.data_ptr(), ids.data_ptr(), o.data_ptr(),
                                 n, bag, v, d, G._DTYPE_CODE[table.dtype],
                                 _lib.sm_count(table), _lib.stream_of(table))
        require(err == 0, f"gather_bags: CUDA error {err}")
        return o

    v = 26 * VOCAB
    n_serve = 26 * 2048
    zipf = [stacked_rows(b, VOCAB) for b in criteo_batches(
        ett, (VOCAB,) * 26, 3, SEED + 5)]
    uniform = [torch.randint(0, v, (n_serve,), generator=gen, device="cuda",
                             dtype=torch.int32) for _ in range(10)]
    bag8 = [torch.randint(0, v, (n_serve, 8), generator=gen, device="cuda",
                          dtype=torch.int32) for _ in range(10)]
    small = [torch.randint(0, 1_000_000, (n_serve,), generator=gen,
                           device="cuda", dtype=torch.int32)
             for _ in range(10)]
    tables = {d: torch.randn((v, d), generator=gen, device="cuda")
              for d in (129, 128, 1)}
    tables["1_bf16"] = tables[1].to(torch.bfloat16)
    for d in (64, 36):
        tables[d] = torch.randn((1_000_000, d), generator=gen, device="cuda")
    # name: (table, id sets, rows or bags)
    shapes = {"d129_zipf": (129, zipf, rows), "d128_zipf": (128, zipf, rows),
              "d1_zipf": (1, zipf, rows), "d1_bf16_zipf": ("1_bf16", zipf, rows),
              "d128_serving": (128, uniform, rows),
              "d64_serving": (64, small, rows), "d36_serving": (36, small, rows),
              "d129_bag8": (129, bag8, bags), "d128_bag8": (128, bag8, bags)}
    reference = {}
    for name, (t, sets, kind) in shapes.items():
        tab = tables[t]
        lib_fn = (lambda i, tab=tab: F.embedding(i, tab)) if kind is rows \
            else (lambda i, tab=tab: F.embedding_bag(i, tab, mode="sum"))
        reference[name] = {
            "library_ms": (time_each_ms(lib_fn, [(s.long(),) for s in sets],
                                        reps=20)
                           if tab.dtype == torch.float32 else None),
            "bound_ms": gather_bound_ms(sets, tab.shape[1],
                                        tab.element_size())}
    checks = {"d129_rows": (tables[129], with_specials(zipf[0].clone(), v, gen)),
              "d1_bf16_rows": (tables["1_bf16"],
                               with_specials(zipf[1].clone(), v, gen)),
              "d129_bags": (tables[129], with_specials(bag8[0].clone(), v, gen))}
    results = []
    for (r, g), lib in libs.items():
        for what, (tab, ids) in checks.items():
            if what.endswith("bags"):
                got, want = bags(lib, tab, ids), G.gather_bags_plain(tab, ids)
            else:
                got, want = rows(lib, tab, ids), G.gather_rows_plain(tab, ids)
            torch.cuda.synchronize()
            require(torch.equal(bits(got), bits(want)),
                    f"gather sweep R = {r}, grid threshold {g}: {what} "
                    "not bitwise")
            del got, want
        row = {"rows_in_flight": r, "grid_vec_min_bytes": g, "bitwise": True}
        for name, (t, sets, kind) in shapes.items():
            tab = tables[t]
            ms = time_each_ms(lambda i, lib=lib, tab=tab, kind=kind:
                              kind(lib, tab, i), [(s,) for s in sets], reps=20)
            row[f"{name}_ms"] = ms
            row[f"{name}_share_of_bound"] = reference[name]["bound_ms"] / ms
        results.append(row)
        emit({"phase": "gather_sweep_row", **row})
    emit({"phase": "gather_sweep", "n_zipf": zipf[0].numel(),
          "n_serving": n_serve, "built": built, "reference": reference,
          "rows": results})


# ---------------------------------------------------------------------------
# Phase 7: stacked training at full width
# ---------------------------------------------------------------------------

class plain_kernels:
    """Route the run-scatter path to the plain versions, on the card."""

    def __init__(self, S, G):
        self.S, self.G = S, G

    def __enter__(self):
        self.saved = (self.S.scatter_add_rows_sorted, self.S.gather_rows)
        self.S.scatter_add_rows_sorted = self.S.scatter_add_rows_sorted_plain
        self.S.gather_rows = self.G.gather_rows_plain

    def __exit__(self, *exc):
        self.S.scatter_add_rows_sorted, self.S.gather_rows = self.saved


class plain_gathers:
    """Route the forward lookups (`ops.lookup`, and `SimpleEmbedding.rows`
    in `tables`) to the plain gathers."""

    def __init__(self, G):
        self.G = G
        self.L = sys.modules["embeddingtables_tpu_torch.ops.lookup"]
        self.T = sys.modules["embeddingtables_tpu_torch.tables"]

    def __enter__(self):
        self.saved = (self.L.gather_rows, self.L.gather_bags,
                      self.T.gather_rows)
        self.L.gather_rows = self.T.gather_rows = self.G.gather_rows_plain
        self.L.gather_bags = self.G.gather_bags_plain

    def __exit__(self, *exc):
        self.L.gather_rows, self.L.gather_bags, self.T.gather_rows = self.saved


class plain_segsum:
    """Route `_dense_grad`'s tiny-table branch to hot_accumulate's plain
    version."""

    def __init__(self, H):
        self.H = H
        self.P = sys.modules["embeddingtables_tpu_torch.optim"]

    def __enter__(self):
        self.saved = self.P.hot_accumulate
        self.P.hot_accumulate = (
            lambda r, x, s, compute_dtype: self.H.hot_accumulate_plain(
                r, x, s, compute_dtype))

    def __exit__(self, *exc):
        self.P.hot_accumulate = self.saved


def card_parity_dense(ett, G, model, cfg, batch, opt, name):
    """One `make_train_step` of a dense-realization optimizer (lazy Adam,
    FTRL) from the same state through the gather kernel and through the
    plain gathers, deterministic algorithms on (index_add_'s float atomics
    would otherwise add in a varying order): tables and every state leaf to
    rtol 1e-6."""
    import copy
    step = ett.make_train_step(cfg, sparse_opt=opt, dense_lr=0.1)
    mk, mp = copy.deepcopy(model), copy.deepcopy(model)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        step(mk, batch["dense"], batch["cat"], batch["label"])
        with plain_gathers(G):
            step(mp, batch["dense"], batch["cat"], batch["label"])
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    torch.testing.assert_close(mk.tables.data, mp.tables.data, rtol=1e-6,
                               atol=1e-7)
    errs = {"tables": max_abs_err(mk.tables.data, mp.tables.data)}
    for f, a, b in zip(type(mk.emb_state)._fields, mk.emb_state, mp.emb_state):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        errs[f] = max_abs_err(a, b) if a.is_floating_point() else \
            float((a - b).abs().max())
    changed = int((mk.tables.data != model.tables.data).any(1).sum())
    zeros = int((mk.tables.data == 0).sum())
    del mk, mp
    torch.cuda.empty_cache()
    emit({"phase": "train_card_parity", "recipe": name,
          "max_abs_err": errs, "rows_changed": changed,
          "exact_zeros": zeros, "tolerance": "rtol 1e-6"})
    return zeros


def card_parity(ett, S, G, model, cfg, batch):
    """One SparseSGD and one indexer-AdaGrad step from the same state and the
    same delta (a real backward of `batch`), through the kernels and through
    the plain versions: SGD bitwise (f32 table), AdaGrad to rtol 1e-6."""
    from embeddingtables_tpu_torch.models.dlrm import (
        bce_loss, embedding_forward, forward_from_embeddings,
        stacked_flat_indices)
    flat, _ = stacked_flat_indices(model.tables, batch["cat"])
    emb = embedding_forward(model.tables, batch["cat"]).requires_grad_(True)
    loss = bce_loss(forward_from_embeddings(
        model.bottom, model.top, cfg, batch["dense"], emb), batch["label"])
    (delta,) = torch.autograd.grad(loss, [emb])
    upd = ett.SparseEmbeddingUpdate(delta=delta.reshape(-1, cfg.dim).float(),
                                    indices=flat)
    out = {}
    for name, opt in (("sgd", ett.SparseSGD(1e-1)),
                      ("adagrad_indexer",
                       ett.SparseRowWiseAdaGrad(1e-2, method="indexer"))):
        state0 = opt.init(model.tables.data)
        if name != "sgd":
            state0.accum.uniform_(0.0, 1e-3)
        dk, dp = model.tables.data.clone(), model.tables.data.clone()
        sk = ett.SparseOptState(state0.accum.clone())
        sp = ett.SparseOptState(state0.accum.clone())
        before = S.scatter_add_rows_sorted.launches
        opt.apply(dk, upd, sk)
        require(S.scatter_add_rows_sorted.launches == before + 1,
                "card parity step did not launch the run-scatter")
        with plain_kernels(S, G):
            opt.apply(dp, upd, sp)
        torch.cuda.synchronize()
        if name == "sgd":
            require(torch.equal(bits(dk), bits(dp)), "SGD step not bitwise")
        else:
            torch.testing.assert_close(dk, dp, rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(sk.accum, sp.accum, rtol=1e-6, atol=0.0)
        out[name] = {"max_abs_err": max_abs_err(dk, dp),
                     "rows_changed": int((dk != model.tables.data).any(1)
                                         .sum())}
        del dk, dp
    emit({"phase": "train_card_parity", "n": flat.numel(), **out})


def step_times(run, examples: int, steps: int = 5,
               hand: dict = HAND_KERNELS) -> dict:
    """Per-step device time (CUDA events over back-to-back calls of
    `run(i)`, the i-th step), host wall, examples/s, and the kernel profile
    of one step (`kernel_profile`'s `hand`)."""
    run(0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(steps):
        run(i)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    return {"step_ms": ms,
            "host_wall_ms": (time.perf_counter() - t0) / steps * 1e3,
            "examples_per_s": examples / (ms / 1e3),
            **kernel_profile(lambda: run(0), ms, reps=2, hand=hand)}


def ctr_runner(step, model, batches, generator=None):
    """`run(i)`: one CTR train step on the i-th of the cycled batches."""
    def run(i):
        b = batches[i % len(batches)]
        return step(model, b["dense"], b["cat"], b["label"],
                    generator=generator)
    return run


def stacked_training_phase(ett, S, H, G, batches):
    t0 = time.perf_counter()
    cfg = ett.dlrm_small_config(vocab=VOCAB)
    cfg16 = dataclasses.replace(cfg, table_dtype=torch.bfloat16)
    # The 4 batches are cycled, so the last 4 steps see the first 4 steps'
    # batches again; the synthetic labels are near balanced and their signal
    # is faint, so the towers learn at 0.1 to make the fall plain in 24 steps.
    steps, dense_lr = 24, 0.1
    recipes = (
        ("sgd", cfg, ett.SparseSGD(1e-4), 1),
        ("adagrad_indexer", cfg,
         ett.SparseRowWiseAdaGrad(1e-3, method="indexer"), 1),
        ("adagrad_auto_dense", cfg, ett.SparseRowWiseAdaGrad(1e-3), 0),
        ("bf16_tables_adagrad_sr", cfg16,
         ett.SparseRowWiseAdaGrad(1e-3, stochastic_rounding=True), 0),
        ("lazy_adam", cfg, ett.SparseLazyAdam(1e-3), 0),
        ("ftrl_l1", cfg, ett.SparseFTRL(0.05, l1=1e-3), 0))
    launches = 0
    for name, rcfg, opt, per_step in recipes:
        r0 = time.perf_counter()
        model = ett.init_dlrm(rcfg, torch.Generator(device="cuda")
                              .manual_seed(SEED), device="cuda",
                              sparse_opt=opt)
        if name == "sgd":
            card_parity(ett, S, G, model, rcfg, batches[0])
        if name in ("lazy_adam", "ftrl_l1"):
            zeros = card_parity_dense(ett, G, model, rcfg, batches[0], opt,
                                      name)
            require(name != "ftrl_l1" or zeros > 0,
                    "FTRL with l1 > 0 made no exact zeros")
        # The peak below is the training's: the parity copies come before.
        torch.cuda.reset_peak_memory_stats()
        zero_scatter(S)
        H.hot_accumulate.launches = 0
        res = ett.train_dlrm(rcfg, itertools.cycle(batches), steps,
                             sparse_opt=opt, dense_lr=dense_lr, model=model,
                             seed=SEED, log_every=1, verbose=False)
        counts = {"scatter_add_rows_sorted": scatter_count(S),
                  "hot_accumulate": H.hot_accumulate.launches}
        losses = res.losses
        require(len(losses) == steps and all(math.isfinite(x) for x in losses),
                f"{name}: non-finite losses {losses}")
        require(statistics.mean(losses[-4:]) < statistics.mean(losses[:4]),
                f"{name}: losses did not fall {losses}")
        require(counts == {"scatter_add_rows_sorted": per_step * steps,
                           "hot_accumulate": 0},
                f"{name}: launches {counts}")
        launches += counts["scatter_add_rows_sorted"]
        step = ett.make_train_step(rcfg, sparse_opt=opt, dense_lr=dense_lr)
        gen = (torch.Generator(device="cuda").manual_seed(SEED)
               if opt.stochastic_rounding else None)
        emit({"phase": "train_stacked", "recipe": name, "batch": B_TRAIN,
              "table_dtype": str(rcfg.tables_dtype).split(".")[1],
              "steps": steps, "losses": losses, "launches": counts,
              "train_dlrm_examples_per_s": res.examples_per_sec,
              **step_times(ctr_runner(step, model, batches, gen), B_TRAIN),
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "seconds": time.perf_counter() - r0})
        del model, res, step
        torch.cuda.empty_cache()
    emit({"phase": "train_stacked_done", "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# Phase 8: per-table training
# ---------------------------------------------------------------------------

def time_per_table_hot_accumulate(H, gen, batches, vocabs, d=128):
    """hot_accumulate on the per-table path's own inputs: the Zipf ids of
    the features of at most 512 padded rows, one call per feature as
    `_dense_grad` makes it (f32), each held against the plain version to
    1e-5 of the summed magnitude, and the sum of the calls' times per step
    beside the sum of their byte bounds n*(4*D + 4) + S*D*4."""
    f32, feats, total, bound = torch.float32, [], 0.0, 0.0
    for j, v in enumerate(vocabs):
        segments = -(-v // 128) * 128
        if segments > 512:
            continue
        sets = [(b["cat"][j].contiguous(),
                 torch.randn((B_TRAIN, d), generator=gen, device="cuda"))
                for b in batches]
        ms = time_each_ms(lambda r, x: H.hot_accumulate(
            r, x, segments, compute_dtype=f32), sets)
        rows, vals = sets[0]
        got = H.hot_accumulate(rows, vals, segments, compute_dtype=f32)
        want = H.hot_accumulate_plain(rows, vals, segments, f32)
        mag = H.hot_accumulate_plain(rows, vals.abs(), segments, f32)
        require(bool(((got - want).abs() <= 1e-5 * mag + 1e-6).all()),
                f"hot_accumulate on feature {j} ({v} rows)")
        counts = torch.bincount(rows.long(), minlength=v)
        feats.append({"feature": j, "vocab": v, "segments": segments,
                      "kernel_ms": ms, "max_abs_err": max_abs_err(got, want),
                      "hottest_id_share": float(counts.max()) / B_TRAIN})
        total += ms
        bound += (B_TRAIN * (4 * d + 4) + segments * d * 4) / HBM_BYTES_PER_S * 1e3
    emit({"phase": "kernel_time", "kernel": "hot_accumulate",
          "inputs": "per_table_tiny_features", "n": B_TRAIN, "D": d,
          "features": feats, "kernel_ms_per_step": total,
          "bound_ms_per_step": bound,
          "tolerance": "1e-5 of sum |vals| per segment"})


def per_table_phase(ett, S, H, gen):
    from embeddingtables_tpu_torch.models.dlrm import (bce_loss,
                                                      forward_from_embeddings)
    from embeddingtables_tpu_torch.optim import apply_dense_tx
    t0 = time.perf_counter()
    vocabs = tuple(min(c, VOCAB) for c in CRITEO_KAGGLE_CARDINALITIES)
    tiny = sum(-(-v // 128) * 128 <= 512 for v in vocabs)
    require(tiny == 9, f"{tiny} tiny tables")
    cfg = ett.DLRMConfig(vocab_sizes=vocabs)
    model = ett.init_dlrm(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                          device="cuda")
    tables = [model.tables.table(t) for t in range(cfg.num_tables)]
    batches = criteo_batches(ett, vocabs, 2, SEED + 7)
    params = list(model.bottom_params) + list(model.top_params)

    def step(opt, b, states):
        nonlocal tables
        outs, pullbacks = zip(*(ett.lookup_vjp(t, b["cat"][j])
                                for j, t in enumerate(tables)))
        emb = torch.stack(outs).requires_grad_(True)
        loss = bce_loss(forward_from_embeddings(
            model.bottom, model.top, cfg, b["dense"], emb), b["label"])
        *grads, demb = torch.autograd.grad(loss, params + [emb])
        apply_dense_tx(params, grads, None, None, 1e-2)
        upds = [pb(demb[j].float()) for j, pb in enumerate(pullbacks)]
        tables, states = ett.ensemble_update(opt, tables, upds, states)
        return loss, states

    hot_total = 0
    for name, opt, want in (("sgd", ett.SparseSGD(1e-2), (9, 17)),
                            ("adagrad_auto_dense",
                             ett.SparseRowWiseAdaGrad(1e-2), (9, 0))):
        states, losses, step_ms = None, [], []
        for i in range(4):
            S.scatter_add_rows_sorted.launches = 0
            H.hot_accumulate.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss, states = step(opt, batches[i % len(batches)], states)
            end.record()
            torch.cuda.synchronize()
            got = (H.hot_accumulate.launches, S.scatter_add_rows_sorted.launches)
            require(got == want, f"per-table {name} step {i}: (hot_accumulate,"
                    f" run-scatter) launches {got}, want {want}")
            hot_total += got[0]
            losses.append(float(loss.detach()))
            step_ms.append(start.elapsed_time(end))
        require(all(math.isfinite(x) for x in losses),
                f"per-table {name}: non-finite losses {losses}")
        # Two more steps under the profiler (outside the counted run).
        held = {"states": states}

        def profiled_step(opt=opt, held=held):
            held["states"] = step(opt, batches[0], held["states"])[1]
        emit({"phase": "train_per_table", "optimizer": name, "batch": B_TRAIN,
              "tables": len(tables), "tiny_tables": tiny,
              "rows": sum(vocabs), "losses": losses,
              "launches_per_step": {"hot_accumulate": want[0],
                                    "scatter_add_rows_sorted": want[1]},
              "step_ms": step_ms,
              **kernel_profile(profiled_step, statistics.median(step_ms[1:]),
                               reps=2)})
    time_per_table_hot_accumulate(H, gen, batches, vocabs)
    emit({"phase": "train_per_table_done",
          "seconds": time.perf_counter() - t0})
    del model, tables
    torch.cuda.empty_cache()
    return hot_total


# ---------------------------------------------------------------------------
# Phase 9: the ensemble API
# ---------------------------------------------------------------------------

class LaunchCounter:
    """The four hand kernels' launch counts: `run(fn)` sets every count to 0
    just before `fn`, reads them just after, and adds them to `total`."""

    def __init__(self, S, H, G):
        self.wrappers = {"gather_rows": G.gather_rows,
                         "gather_bags": G.gather_bags,
                         "scatter_add_rows_sorted": S.scatter_add_rows_sorted,
                         "hot_accumulate": H.hot_accumulate}
        self.total = dict.fromkeys(self.wrappers, 0)

    def run(self, fn):
        for w in self.wrappers.values():
            w.launches = 0
        scatter = self.wrappers["scatter_add_rows_sorted"]
        scatter.classes = collections.Counter()
        out = fn()
        torch.cuda.synchronize()
        got = {k: w.launches for k, w in self.wrappers.items()}
        SCATTER_CLASSES.update(scatter.classes)
        for k, n in got.items():
            self.total[k] += n
        return out, got


def events_ms(fn, reps: int = 3) -> list:
    """CUDA-event time of each of `reps` calls of `fn`."""
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def ensemble_phase(ett, S, H, G, gen):
    """maplookup, maplookup_vjp + ensemble_sgd_update, ensemble_update with
    lazy Adam and FTRL, SplitEmbedding under indexer AdaGrad, and index()
    on the 26 Criteo Kaggle features (capped at 250,000 rows), B = 65,536.
    Returns the launches of each kernel in the counted runs."""
    t0 = time.perf_counter()
    vocabs = tuple(min(c, VOCAB) for c in CRITEO_KAGGLE_CARDINALITIES)
    d, nt, pre = 128, len(vocabs), 128
    base = torch.empty((sum(vocabs), d), device="cuda").uniform_(
        -1.0, 1.0, generator=gen) / d ** 0.5
    offs = np.concatenate([[0], np.cumsum(vocabs)]).tolist()

    def fresh():
        return [ett.SimpleEmbedding(base[offs[j]:offs[j + 1]].clone())
                for j in range(nt)]
    (batch,) = criteo_batches(ett, vocabs, 1, SEED + 8)
    cat = batch["cat"]                                     # (26, B) int32
    counter = LaunchCounter(S, H, G)
    counted = counter.run

    # 1. maplookup under PreallocationStrategy(128): a list, a StackedTables,
    #    and bags of 8; each bitwise the plain path.
    strat = ett.PreallocationStrategy(prependrows=pre)
    tables = fresh()
    fused, got = counted(lambda: ett.maplookup(strat, tables, cat))
    require(tuple(fused.shape) == (B_TRAIN, pre + nt * d)
            and fused.dtype == torch.float32, f"fused shape {fused.shape}")
    require(bool(torch.isfinite(fused).all()), "non-finite maplookup output")
    require(got["gather_rows"] == nt, f"list maplookup launches {got}")
    with plain_gathers(G):
        plain = ett.maplookup(strat, tables, cat)
    require(torch.equal(bits(fused), bits(plain))
            and not bool(fused[:, :pre].any()), "list maplookup not bitwise")
    stacked = ett.StackedTables.stack(tables)
    fused_st, got = counted(lambda: ett.maplookup(strat, stacked, cat))
    require(got["gather_rows"] == 1, f"stacked maplookup launches {got}")
    require(torch.equal(bits(fused_st), bits(plain)),
            "stacked maplookup not bitwise")
    # 8,192 bags of 8 per table: the same 65,536 ids per table.
    bags = torch.stack([torch.randint(0, v, (B_TRAIN // 8, 8), generator=gen,
                                      device="cuda", dtype=torch.int32)
                        for v in vocabs])
    fused_b, got = counted(lambda: ett.maplookup(strat, tables, bags))
    require(got["gather_bags"] == nt and got["gather_rows"] == 0,
            f"bag maplookup launches {got}")
    with plain_gathers(G):
        plain_b = ett.maplookup(strat, tables, bags)
    torch.testing.assert_close(fused_b, plain_b, rtol=1e-6, atol=0.0)
    times = {"maplookup_list_ms": events_ms(
                 lambda: ett.maplookup(strat, tables, cat)),
             "maplookup_stacked_ms": events_ms(
                 lambda: ett.maplookup(strat, stacked, cat)),
             "maplookup_bags8_ms": events_ms(
                 lambda: ett.maplookup(strat, tables, bags))}
    del fused, fused_st, fused_b, plain, plain_b, stacked
    emit({"phase": "ensemble_maplookup", "batch": B_TRAIN, "tables": nt,
          "rows": sum(vocabs), "out_shape": [B_TRAIN, pre + nt * d],
          "bitwise": True, "bag8_max_abs_err": 0.0, **times})

    # 2. maplookup_vjp + ensemble_sgd_update(method="dedup"): 26 run-scatter
    #    launches a step, bitwise the plain run-scatter on the same streams.
    # Multiples of 2^-13 below 2^-5: every sum of up to 2^16 of them is
    # exact in f32, in any order, so the kernels' atomics (hot_accumulate)
    # and index_add_'s give the plain versions' bits.
    delta = torch.round(64 * torch.randn((B_TRAIN, pre + nt * d),
                                         generator=gen, device="cuda")
                        ).clamp(-255, 255) / 8192
    plain_tables = fresh()

    def sgd_step(ts):
        _, pull = ett.maplookup_vjp(strat, ts, cat)
        return ett.ensemble_sgd_update(ts, pull(delta), 0.1, method="dedup",
                                       indexer=ett.SparseIndexer())
    _, got = counted(lambda: sgd_step(tables))
    require(got["scatter_add_rows_sorted"] == nt,
            f"ensemble_sgd_update launches {got}")
    with plain_kernels(S, G), plain_gathers(G):
        sgd_step(plain_tables)
    require(all(torch.equal(bits(a.data), bits(b.data))
                for a, b in zip(tables, plain_tables)),
            "ensemble_sgd_update not bitwise the plain run-scatter")
    sgd_ms = events_ms(lambda: sgd_step(tables))
    del plain_tables
    emit({"phase": "ensemble_sgd_update", "method": "dedup",
          "indexer": "SparseIndexer", "launches_per_step": got,
          "bitwise": True, "step_ms": sgd_ms,
          **kernel_profile(lambda: sgd_step(tables),
                           statistics.median(sgd_ms), reps=2)})

    # 3. ensemble_update with lazy Adam and FTRL: 9 hot_accumulate and no
    #    run-scatter launches a step; one step against the plain version.
    tiny = sum(-(-v // 128) * 128 <= 512 for v in vocabs)
    for name, opt in (("lazy_adam", ett.SparseLazyAdam(1e-3)),
                      ("ftrl_l1", ett.SparseFTRL(0.05, l1=1e-3))):
        tk, tp = fresh(), fresh()
        states_k = [opt.init(t.data) for t in tk]
        states_p = [opt.init(t.data) for t in tp]

        def upd_step(ts, states):
            _, pull = ett.maplookup_vjp(strat, ts, cat)
            return ett.ensemble_update(opt, ts, pull(delta), states)[1]
        states_k, got = counted(lambda: upd_step(tk, states_k))
        require(got["hot_accumulate"] == tiny == 9
                and got["scatter_add_rows_sorted"] == 0,
                f"{name} ensemble_update launches {got}")
        with plain_gathers(G), plain_segsum(H):
            states_p = upd_step(tp, states_p)
        torch.cuda.synchronize()
        # The delta's sums are exact, so the step is bitwise the plain one.
        for a, b, sa, sb in zip(tk, tp, states_k, states_p):
            require(torch.equal(bits(a.data), bits(b.data))
                    and all(torch.equal(x, y) for x, y in zip(sa, sb)),
                    f"{name} ensemble_update not bitwise the plain version")
        ms = events_ms(lambda: upd_step(tk, states_k))
        emit({"phase": "ensemble_update", "optimizer": name,
              "launches_per_step": got, "bitwise": True, "step_ms": ms,
              **kernel_profile(lambda: upd_step(tk, states_k),
                               statistics.median(ms), reps=2)})
        del tk, tp, states_k, states_p
    torch.cuda.empty_cache()

    # 4. The six features of VOCAB rows as SplitEmbeddings of SHARD_ROWS-row
    #    shards (4 each, the last ragged) under indexer AdaGrad: 4 run-scatter
    #    launches a table, against the same update on SimpleEmbeddings.
    big = [j for j, v in enumerate(vocabs) if v == VOCAB]
    require(len(big) == 6, f"{len(big)} features of {VOCAB} rows")
    opt = ett.SparseRowWiseAdaGrad(1e-2, method="indexer")
    splits = [ett.SplitEmbedding(base[offs[j]:offs[j + 1]], SHARD_ROWS)
              for j in big]
    require(all(s.nshards == 4 and s.shards[-1].shape[0] == VOCAB - 3 * SHARD_ROWS
                for s in splits), "split shapes")
    simples = [ett.SimpleEmbedding(base[offs[j]:offs[j + 1]].clone())
               for j in big]
    # Unrounded deltas: the shards' streams cut the run-scatter's windows
    # elsewhere than the whole tables' do, so the f32 sums differ in order.
    upds = [ett.SparseEmbeddingUpdate(
        delta=1e-2 * torch.randn((B_TRAIN, d), generator=gen, device="cuda"),
        indices=cat[j]) for j in big]
    (_, split_states), got = counted(
        lambda: ett.ensemble_update(opt, splits, upds))
    require(got["scatter_add_rows_sorted"] == 4 * len(big),
            f"split ensemble_update launches {got}")
    _, simple_states = ett.ensemble_update(opt, simples, upds)
    err = 0.0
    for sp, si, a, b in zip(splits, simples, split_states, simple_states):
        torch.testing.assert_close(sp.materialize(), si.data, rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(a.accum, b.accum, rtol=1e-6, atol=0.0)
        err = max(err, max_abs_err(sp.materialize(), si.data))
    split_ms = events_ms(lambda: ett.ensemble_update(opt, splits, upds,
                                                     split_states))
    simple_ms = events_ms(lambda: ett.ensemble_update(opt, simples, upds,
                                                      simple_states))
    emit({"phase": "ensemble_split", "tables": len(big), "rows": VOCAB,
          "rows_per_shard": SHARD_ROWS, "shards": 4,
          "launches_per_step": got, "max_abs_err_vs_simple": err,
          "tolerance": "rtol 1e-6", "split_step_ms": split_ms,
          "simple_step_ms": simple_ms})
    del splits, simples, upds, split_states, simple_states

    # 5. index() on the card, for the record: one feature and the stacked
    #    stream.
    stacked_ids = (cat + torch.tensor(offs[:-1], device="cuda",
                                      dtype=torch.int32)[:, None]).reshape(-1)
    idx_times = []
    for label, ids, v in (("one_feature", cat[big[0]], VOCAB),
                          ("stacked", stacked_ids, sum(vocabs))):
        for ix in (ett.SparseIndexer(), ett.DenseIndexer()):
            res = ett.index(ids, vocab=v, indexer=ix)
            idx_times.append({
                "stream": label, "n": ids.numel(), "vocab": v,
                "indexer": type(ix).__name__,
                "num_unique": int(res.num_unique),
                "ms": statistics.median(events_ms(
                    lambda: ett.index(ids, vocab=v, indexer=ix), reps=5))})
    emit({"phase": "ensemble_index", "rows": idx_times})
    del base, delta, tables, batch, cat, bags
    torch.cuda.empty_cache()
    emit({"phase": "ensemble_done", "seconds": time.perf_counter() - t0,
          "launches": counter.total})
    return counter.total


# ---------------------------------------------------------------------------
# Phase 10: the other model families (DCN-v2, DeepFM, two-tower)
# ---------------------------------------------------------------------------

class config_as:
    """Serve or evaluate `model` under another config (f32 towers, bags)
    for the length of a block; the eval steps read `model.config`."""

    def __init__(self, model, cfg):
        self.model, self.cfg = model, cfg

    def __enter__(self):
        self.saved, self.model.config = self.model.config, self.cfg
        return self.model

    def __exit__(self, *exc):
        self.model.config = self.saved


def latency_ms(lats) -> dict:
    ms = sorted(1e3 * x for x in lats)
    return {"latency_samples": len(ms),
            "latency_ms_p50": float(np.percentile(ms, 50)),
            "latency_ms_p95": float(np.percentile(ms, 95)),
            "latency_ms_p99": float(np.percentile(ms, 99))}


def closed_loop(svc, make_req, clients: int = 8, per_client: int = 8):
    """`clients` threads, each sending `per_client` requests of 1-256
    examples one after another and waiting for each: [(request, result,
    latency_s)]."""
    served, lock = [], threading.Lock()

    def client(k):
        rng = np.random.default_rng(SEED + 3000 + k)
        for _ in range(per_client):
            req = make_req(rng, int(rng.integers(1, 257)))
            t0 = time.perf_counter()
            out = svc.predict(*req, timeout=300)
            lat = time.perf_counter() - t0
            with lock:
                served.append((req, out, lat))

    with ThreadPoolExecutor(max_workers=clients) as pool:
        for f in [pool.submit(client, k) for k in range(clients)]:
            f.result()
    return served


def step_parity(S, G, step, model, args, rtol=None):
    """One train step from the same state through the kernels and through
    the plain versions (deep copies of `model`): the towers bitwise, the
    tables and row states bitwise (`rtol=None`) or to `rtol`. Returns the
    largest table and state error."""
    import copy
    mk, mp = copy.deepcopy(model), copy.deepcopy(model)
    step(mk, *args)
    with plain_kernels(S, G), plain_gathers(G):
        step(mp, *args)
    torch.cuda.synchronize()
    for (name, a), (_, b) in zip(mk.named_parameters(),
                                 mp.named_parameters()):
        require(torch.equal(bits(a.detach()), bits(b.detach())),
                f"step parity: tower {name} differs")
    err = 0.0
    for (name, a), (_, b) in zip(mk.named_buffers(), mp.named_buffers()):
        if not a.is_floating_point() or a.numel() == 0:
            require(torch.equal(a, b), f"step parity: {name} differs")
        elif rtol is None:
            require(torch.equal(bits(a), bits(b)),
                    f"step parity: {name} not bitwise")
        else:
            torch.testing.assert_close(a, b, rtol=rtol, atol=1e-7)
        if a.is_floating_point() and a.numel():
            err = max(err, max_abs_err(a, b))
    del mk, mp
    torch.cuda.empty_cache()
    return err


def ctr_family_serving(ett, G, counter, name, mod, model, make_service):
    """A CTR family's service at full width: 8 closed-loop clients, 64
    requests of 1-256 examples, `gather_rows` launches = served batches;
    then one batch through the kernels against the plain gathers with f32
    towers (rtol 1e-5), and a bag-8 batch through `gather_bags`."""
    cfg = model.config
    svc = make_service(model, max_batch=2048, max_latency_ms=2.0)
    try:
        warm = np.random.default_rng(SEED + 98)
        for b in (1, 256, 2048):
            svc.predict(*make_request(warm, cfg, b), timeout=300)
        before = svc.stats_snapshot()["batches"]
        t0 = time.perf_counter()
        served, got = counter.run(lambda: closed_loop(
            svc, lambda rng, b: make_request(rng, cfg, b)))
        wall = time.perf_counter() - t0
        stats = svc.stats_snapshot()
        batches = stats["batches"] - before
    finally:
        svc.stop()
    require(len(served) == 64 and all(
        np.isfinite(o).all() and o.shape == (r[0].shape[0],)
        for r, o, _ in served), f"{name}: non-finite or missing scores")
    require(got["gather_rows"] == batches > 0,
            f"{name}: gather_rows launches {got['gather_rows']} != served "
            f"batches {batches}")
    sample = served[:16]
    dense = np.concatenate([r[0] for r, _, _ in sample])
    cat = np.concatenate([r[1] for r, _, _ in sample], axis=1)
    service = np.concatenate([o for _, o, _ in sample])
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    ev = mod.make_eval_step(cfg32)
    with config_as(model, cfg32):
        kern32 = ev(model, dense, cat)
        with plain_gathers(G):
            ref = ev(model, dense, cat)
        torch.testing.assert_close(kern32, ref, rtol=1e-5, atol=1e-6)
    ref = ref.cpu().numpy()
    cfgb = dataclasses.replace(cfg32, bag=8)
    db, cb = make_request(np.random.default_rng(SEED + 97), cfgb, 2048, 8)
    with config_as(model, cfgb):
        outb, gotb = counter.run(lambda: ev(model, db, cb))
        with plain_gathers(G):
            refb = ev(model, db, cb)
    require(gotb["gather_bags"] == 1 and gotb["gather_rows"] == 0
            and bool(torch.isfinite(outb).all()),
            f"{name}: bag-8 launches {gotb}")
    torch.testing.assert_close(outb, refb, rtol=1e-5, atol=1e-6)
    emit({"phase": "family_serve", "family": name,
          "requests": len(served),
          "examples": sum(r[0].shape[0] for r, _, _ in served),
          "wall_s": wall, "batches": batches, "launches": got,
          **latency_ms([lat for _, _, lat in served]), "batcher_stats": stats,
          "kernel_f32_vs_plain_f32_max_abs": float(
              np.abs(kern32.cpu().numpy() - ref).max()),
          "service_bf16_vs_plain_f32_max_abs": float(
              np.abs(service - ref).max()),
          "max_abs_logit": float(np.abs(ref).max()),
          "bag8_launches": gotb,
          "bag8_kernel_vs_plain_max_abs": float((outb - refb).abs().max())})


def ctr_family_training(ett, S, G, counter, name, mod, train, recipes,
                        batches, steps: int = 12):
    """Each recipe `(label, cfg, optimizer, stacks, parity rtol)`: one step
    held against the plain versions, then `train` for `steps` steps of the
    cycled batches with run-scatter launches = steps x stacks and a falling
    loss, then step times, idle share and peak memory. Returns the last
    recipe's model and each recipe's step ms."""
    step_ms, model = {}, None
    for label, cfg, opt, stacks, rtol in recipes:
        r0 = time.perf_counter()
        del model
        torch.cuda.empty_cache()
        init = getattr(ett, f"init_{name}")
        model = init(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                     device="cuda", sparse_opt=opt)
        step = mod.make_train_step(cfg, sparse_opt=opt, dense_lr=0.1)
        b0 = batches[0]
        err = step_parity(S, G, step, model,
                          (b0["dense"], b0["cat"], b0["label"]), rtol)
        torch.cuda.reset_peak_memory_stats()
        res, got = counter.run(lambda: train(
            cfg, itertools.cycle(batches), steps, sparse_opt=opt,
            dense_lr=0.1, model=model, seed=SEED, log_every=1,
            verbose=False))
        losses = res.losses
        require(len(losses) == steps and all(math.isfinite(x)
                                             for x in losses),
                f"{name} {label}: non-finite losses {losses}")
        require(statistics.mean(losses[-4:]) < statistics.mean(losses[:4]),
                f"{name} {label}: losses did not fall {losses}")
        require(got["scatter_add_rows_sorted"] == steps * stacks
                and got["hot_accumulate"] == 0,
                f"{name} {label}: launches {got}, want "
                f"{steps * stacks} run-scatters")
        peak = torch.cuda.max_memory_allocated() / 1e9
        t = step_times(ctr_runner(step, model, batches), B_TRAIN)
        step_ms[label] = t["step_ms"]
        emit({"phase": "family_train", "family": name, "recipe": label,
              "batch": B_TRAIN, "stack_width": model.tables.data.shape[1],
              "steps": steps, "losses": losses, "launches": got,
              "launches_per_step": {k: v / steps for k, v in got.items()},
              "parity": "bitwise" if rtol is None else f"rtol {rtol}",
              "parity_max_abs_err": err,
              "train_examples_per_s": res.examples_per_sec, **t,
              "peak_memory_gb": peak, "seconds": time.perf_counter() - r0})
    return model, step_ms


def time_gather(G, gen, sets, v, d, label):
    """`gather_rows` at one shape, f32 table: its time beside its plain
    version, `F.embedding` and the byte bound U*D*4 (each unique row read
    once) + n*4 (ids) + n*D*4 (the output)."""
    table = torch.randn((v, d), generator=gen, device="cuda")
    n = sets[0].numel()
    uniq = statistics.mean(int(torch.unique(s).numel()) for s in sets)
    nbytes = uniq * d * 4 + n * 4 + n * d * 4
    t = {"kernel_ms": time_each_ms(lambda i: G.gather_rows(table, i),
                                   [(s,) for s in sets], reps=20),
         "plain_ms": time_each_ms(lambda i: G.gather_rows_plain(table, i),
                                  [(s,) for s in sets], reps=10),
         "library_ms": time_each_ms(
             lambda i: torch.nn.functional.embedding(i, table),
             [(s.long(),) for s in sets], reps=20),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit({"phase": "kernel_time", "kernel": "gather_rows", "stream": label,
          "dtype": "float32", "V": v, "D": d, "n": n, "unique_rows": uniq,
          "bytes": nbytes, **t})
    return t


def time_gather_bags(G, gen, v, d, n=26 * 2048, bag=8):
    """`gather_bags` at one shape, f32 table, uniform ids: its time beside
    its plain version, `F.embedding_bag` and the byte bound."""
    table = torch.randn((v, d), generator=gen, device="cuda")
    sets = [torch.randint(0, v, (n, bag), generator=gen, device="cuda",
                          dtype=torch.int32) for _ in range(10)]
    t = {"kernel_ms": time_each_ms(lambda i: G.gather_bags(table, i),
                                   [(s,) for s in sets], reps=20),
         "plain_ms": time_each_ms(lambda i: G.gather_bags_plain(table, i),
                                  [(s,) for s in sets], reps=10),
         "library_ms": time_each_ms(
             lambda i: torch.nn.functional.embedding_bag(i, table, mode="sum"),
             [(s.long(),) for s in sets], reps=20),
         "bound_ms": gather_bound_ms(sets, d), "bound_by": "bytes"}
    emit({"phase": "kernel_time", "kernel": "gather_bags", "stream": "uniform",
          "dtype": "float32", "V": v, "D": d, "n": n, "bag": bag, **t})
    return t


def family_width_kernels(S, G, gen, batches):
    """The kernels at DeepFM's widths, D + 1 = 129 (the fused stack) and
    D = 1 (the unfolded first-order stack), on the card: `gather_rows`
    bitwise (also on tables whose base is 4 or 2 bytes off the 16-byte
    grid), `gather_bags` (bags of 8) within rtol 1e-6, the run-scatter's SGD
    epilogue bitwise on f32 and bf16 tables and its AdaGrad epilogue to rtol
    1e-6, on Zipf streams with padding and rows >= V and on the window-edge
    stream; then `gather_rows` and the run-scatter timed at D = 129, 128 and
    1 on the training path's Zipf ids, and `gather_bags` at D = 129 on
    uniform bags of 8 at the serving shape."""
    v = 26 * VOCAB
    zipf = [stacked_rows(b, VOCAB) for b in batches[:3]]
    errs = {"gather_rows": 0.0, "gather_bags": 0.0,
            "scatter_add_rows_sorted": 0.0}
    for d in (129, 1):
        t32 = torch.randn((v, d), generator=gen, device="cuda")
        for tab in (t32, t32.to(torch.bfloat16)):
            dt = str(tab.dtype).split(".")[1]
            ids = with_specials(zipf[0].clone(), v, gen)
            got, want = G.gather_rows(tab, ids), G.gather_rows_plain(tab, ids)
            torch.cuda.synchronize()
            require(torch.equal(bits(got), bits(want)),
                    f"gather_rows D={d} {tab.dtype} not bitwise")
            emit({"phase": "kernel_check", "kernel": "gather_rows",
                  "dtype": dt, "V": v, "D": d, "n": ids.numel(),
                  "bitwise": True, "nan_rows": int(got.isnan().any(1).sum())})
            del got, want
            ids = with_specials(torch.randint(
                0, v, (26 * 2048, 8), generator=gen, device="cuda",
                dtype=torch.int32), v, gen)
            got, want = G.gather_bags(tab, ids), G.gather_bags_plain(tab, ids)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=1e-6,
                                       atol=0.0, equal_nan=True)
            err = max_abs_err(got, want)
            errs["gather_bags"] = max(errs["gather_bags"], err)
            emit({"phase": "kernel_check", "kernel": "gather_bags",
                  "dtype": dt, "V": v, "D": d, "n": ids.shape[0], "bag": 8,
                  "max_abs_err": err, "rtol": 1e-6,
                  "bitwise_outside_nan_rows": torch.equal(
                      bits(got)[~want.isnan()], bits(want)[~want.isnan()])})
            del got, want
        del t32
        errs["scatter_add_rows_sorted"] = max(
            errs["scatter_add_rows_sorted"], check_scatter(
                S, gen, {"zipf": with_padding(zipf[1], v, gen),
                         "window_edges": window_edge_stream(S.RUN_WINDOW, v)},
                v, d))
        torch.cuda.empty_cache()
    # Tables whose base lies 4 (f32, bf16) or 2 (bf16) bytes past the
    # 16-byte grid: a contiguous (V, 129) view one or two elements into
    # its buffer.
    vs = 1_000_000
    for dtype, offset in ((torch.float32, 1), (torch.bfloat16, 2),
                          (torch.bfloat16, 1)):
        buf = torch.randn((vs * 129 + offset,), generator=gen,
                          device="cuda").to(dtype)
        tab = buf[offset:].view(vs, 129)
        ids = with_specials(torch.randint(0, vs, (zipf[0].numel(),),
                                          generator=gen, device="cuda",
                                          dtype=torch.int32), vs, gen)
        got, want = G.gather_rows(tab, ids), G.gather_rows_plain(tab, ids)
        torch.cuda.synchronize()
        require(torch.equal(bits(got), bits(want)),
                f"gather_rows {dtype} base +{offset} elements not bitwise")
        emit({"phase": "kernel_check", "kernel": "gather_rows",
              "dtype": str(dtype).split(".")[1], "V": vs, "D": 129,
              "n": ids.numel(), "base_offset_bytes": offset * buf.element_size(),
              "bitwise": True})
        del buf, tab, got, want
    timings = {}
    for d in (129, 128, 1):
        timings[f"gather_rows_d{d}"] = time_gather(G, gen, zipf, v, d,
                                                   f"zipf_d{d}")
        timings[f"scatter_d{d}"] = time_scatter(S, G, gen, zipf, v, d,
                                                f"zipf_d{d}")
        torch.cuda.empty_cache()
    timings["gather_bags_d129"] = time_gather_bags(G, gen, v, 129)
    torch.cuda.empty_cache()
    emit({"phase": "family_width_times", "n": zipf[0].numel(),
          **{k: {"kernel_ms": t["kernel_ms"], "bound_ms": t["bound_ms"],
                 "share_of_bound": t["bound_ms"] / t["kernel_ms"],
                 "library_ms": t["library_ms"]} for k, t in timings.items()}})
    return errs, timings


def two_tower_phase(ett, S, G, counter):
    """The retriever at the repo's two-tower shape (dim 64, MLPs 256-64, 4
    dense features, f32) with 1M / 100k / 1k query rows and 2M items,
    B = 16,384: one step bitwise the plain step, `train_two_tower` for 12
    steps (2 run-scatters a step, falling loss, recall@10 over 2 eval
    batches of 1,024), the item index (31 `gather_rows`), and
    `make_retrieval_service` against the plain path."""
    t0 = time.perf_counter()
    tt = ett.models.two_tower
    cfg = ett.TwoTowerConfig(query_vocab_sizes=TT_QUERY_VOCABS,
                             item_vocab=TT_ITEMS, num_dense=4, dim=64,
                             embed_dim=64, query_mlp=(256, 64),
                             item_mlp=(256, 64))
    bsz, steps = TT_BATCH, 12
    batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
               for b in ett.SyntheticRetrieval(
                   cfg.query_vocab_sizes, cfg.item_vocab, num_dense=4,
                   batch_size=bsz, seed=SEED + 20).batches(4)]
    evals = list(ett.SyntheticRetrieval(
        cfg.query_vocab_sizes, cfg.item_vocab, num_dense=4,
        batch_size=TT_EVAL_BATCH, seed=SEED + 21).batches(2))
    opt = ett.SparseSGD(0.05)
    model = ett.init_two_tower(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda",
        sparse_opt=opt)
    step = tt.make_train_step(cfg, sparse_opt=opt)

    def run(i):
        b = batches[i % len(batches)]
        return step(model, b["dense"], b["q_cat"], b["item_ids"])
    b0 = batches[0]
    step_parity(S, G, step, model, (b0["dense"], b0["q_cat"],
                                    b0["item_ids"]))
    torch.cuda.reset_peak_memory_stats()
    res, got = counter.run(lambda: ett.train_two_tower(
        cfg, itertools.cycle(batches), steps, sparse_opt=opt, model=model,
        seed=SEED, eval_batches=evals, eval_every=steps, k=10, log_every=1,
        verbose=False))
    losses = res.losses
    require(all(math.isfinite(x) for x in losses)
            and statistics.mean(losses[-4:]) < statistics.mean(losses[:4]),
            f"two-tower losses did not fall {losses}")
    require(got["scatter_add_rows_sorted"] == 2 * steps
            and got["hot_accumulate"] == 0, f"two-tower launches {got}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    times = step_times(run, bsz)          # trains on: the index comes after
    index, got_index = counter.run(lambda: tt.build_item_index(model))
    require(got_index["gather_rows"] == -(-cfg.item_vocab // 65_536),
            f"build_item_index launches {got_index}")
    index_ms = events_ms(lambda: tt.build_item_index(model))
    emit({"phase": "two_tower_train", "batch": bsz, "steps": steps,
          "losses": losses, "in_batch_accs": res.accs,
          "recall_at_10": res.recalls, "eval_queries": 2 * TT_EVAL_BATCH,
          "launches": got, "train_examples_per_s": res.examples_per_sec,
          "index_launches": got_index, "build_item_index_ms": index_ms,
          "parity": "bitwise",
          **times, "peak_memory_gb": peak})

    # Retrieval: the kernel path and the plain path on one batch (bitwise),
    # then the service against the plain path.
    run10 = tt.make_retriever(model, k=10)
    with plain_gathers(G):
        index_p = tt.build_item_index(model)
    require(torch.equal(bits(index), bits(index_p)), "item index not bitwise")
    e = evals[0]
    ks, ki = run10(index, e["dense"][:256], e["q_cat"][:, :256])
    with plain_gathers(G):
        ps, pi = run10(index_p, e["dense"][:256], e["q_cat"][:, :256])
    require(torch.equal(ki, pi) and torch.equal(bits(ks), bits(ps)),
            "retrieval kernel path != plain path")
    svc = ett.make_retrieval_service(model, k=10, max_batch=256,
                                     max_latency_ms=2.0)
    rng_q = np.random.default_rng(SEED + 22)

    def make_req(rng, b):
        return (rng.standard_normal((b, 4)).astype(np.float32),
                np.stack([rng.integers(0, v, b) for v in
                          cfg.query_vocab_sizes]).astype(np.int32))
    try:
        for b in (1, 256):
            svc.predict(*make_req(rng_q, b), timeout=300)
        before = svc.stats_snapshot()["batches"]
        served, got_s = counter.run(lambda: closed_loop(svc, make_req))
        stats = svc.stats_snapshot()
        batches_served = stats["batches"] - before
    finally:
        svc.stop()
    require(len(served) == 64 and got_s["gather_rows"] == batches_served,
            f"retrieval service launches {got_s}, batches {batches_served}")
    # Each request's batch was scored inside a padded bucket, so its
    # product may round differently from the plain path's: ids are held
    # equal except where two plain scores lie within 1e-5 of each other.
    near_ties, err = 0, 0.0
    for (dense, q_cat), (scores, ids), _ in served[:16]:
        with plain_gathers(G):
            ps, pi = run10(index_p, dense, q_cat)
        ps, pi = ps.cpu().numpy(), pi.cpu().numpy()
        np.testing.assert_allclose(scores, ps, rtol=1e-5, atol=1e-6)
        err = max(err, float(np.abs(scores - ps).max()))
        near_ties += retrieval_ids_match(ids, ps, pi)
    emit({"phase": "two_tower_serve", "k": 10, "requests": len(served),
          "queries": sum(r[0].shape[0] for r, _, _ in served),
          "batches": batches_served, "launches": got_s,
          **latency_ms([lat for _, _, lat in served]),
          "scores_max_abs_vs_plain": err, "near_tie_positions": near_ties,
          "batcher_stats": stats, "seconds": time.perf_counter() - t0})
    del model, index, index_p, batches
    torch.cuda.empty_cache()


def families_phase(ett, S, H, G, gen, batches):
    """DCN-v2 and DeepFM (folded and unfolded) at the Criteo-shaped width
    (26 x 250,000 rows, dim 128) on the stacked training batches, the
    kernels at DeepFM's widths, and the two-tower retriever. Returns the
    launches of each kernel in the counted runs, the width checks' errors
    and the D = 129 times."""
    t0 = time.perf_counter()
    counter = LaunchCounter(S, H, G)
    M = ett.models
    sgd, ada = ett.SparseSGD(1e-4), ett.SparseRowWiseAdaGrad(
        1e-3, method="indexer")

    dcn_cfg = ett.dcn_small_config(vocab=VOCAB)
    model, dcn_ms = ctr_family_training(
        ett, S, G, counter, "dcn", M.dcn, ett.train_dcn,
        (("sgd", dcn_cfg, sgd, 1, None),
         ("adagrad_indexer", dcn_cfg, ada, 1, 1e-6)), batches)
    ctr_family_serving(ett, G, counter, "dcn", M.dcn, model,
                       ett.make_dcn_service)
    del model
    torch.cuda.empty_cache()

    fm_cfg = ett.deepfm_small_config(vocab=VOCAB)
    unfolded = dataclasses.replace(fm_cfg, fold_fm_w=False)
    model, fm_ms = ctr_family_training(
        ett, S, G, counter, "deepfm", M.deepfm, ett.train_deepfm,
        (("folded_sgd", fm_cfg, sgd, 1, None),
         ("folded_adagrad_indexer", fm_cfg, ada, 1, 1e-6),
         ("unfolded_sgd", unfolded, sgd, 2, None)), batches)
    # The unfolded model, fused, scores as it did (f32 towers).
    cfg32 = dataclasses.replace(unfolded, compute_dtype=torch.float32)
    d, c = make_request(np.random.default_rng(SEED + 96), cfg32, 2048)
    with config_as(model, cfg32):
        want = M.deepfm.make_eval_step(cfg32)(model, d, c)
        fused = ett.fuse_deepfm(model)           # f32 towers, folded
    got = M.deepfm.make_eval_step(fused.config)(fused, d, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    emit({"phase": "deepfm_fuse", "fused_stack": list(fused.tables.data.shape),
          "max_abs_vs_unfolded": float((got - want).abs().max()),
          "step_ms_folded_sgd": fm_ms["folded_sgd"],
          "step_ms_unfolded_sgd": fm_ms["unfolded_sgd"]})
    del model
    fused.config = fm_cfg
    ctr_family_serving(ett, G, counter, "deepfm", M.deepfm, fused,
                       ett.make_deepfm_service)
    del fused
    torch.cuda.empty_cache()

    errs, timings = family_width_kernels(S, G, gen, batches)
    two_tower_phase(ett, S, G, counter)
    emit({"phase": "families_done", "seconds": time.perf_counter() - t0,
          "launches": counter.total, "dcn_step_ms": dcn_ms,
          "deepfm_step_ms": fm_ms})
    return counter.total, errs, timings


# ---------------------------------------------------------------------------
# Phase 10, last part: MLPerf DLRM-DCNv2's multi-hot bags
# ---------------------------------------------------------------------------

# The benchmark's configuration of the model: one card's share of its tables
# (51,883,621 x 128 f32), the published bag widths, the dense arch.
MLPERF_DCN_CONFIG = "portbench/configs/dlrm_dcnv2_mlperf.json"
MULTIHOT_KERNELS = {"gather_bags_ragged": "gather_bags_ragged",
                    "gather_rows": "gather_rows_",
                    "scatter_add_rows_sorted": "runscatter_"}


def multihot_dcn_phase(ett, S, H, G, gen, b: int = B_TRAIN,
                       steps: int = 4):
    """MLPerf DLRM-DCNv2 at the benchmark cell's shapes (S = 214 ids an
    example in 26 bags of the published widths, D = 128, f32 tables, B =
    65,536; Zipf(1.1) ids drawn slot by slot): `make_train_step` with
    indexer AdaGrad, each hand kernel's launches counted over `steps` steps
    (one `gather_bags_ragged`, one `gather_rows` (the update's permute) and
    one run-scatter a step, no `gather_bags` and no `hot_accumulate`);
    `gather_bags_ragged` bitwise
    its plain version on a step's ids; then its time beside its plain
    version, `F.embedding_bag` with per-bag offsets and the byte bound of
    those ids (4 bytes an id, each distinct row read once, the T * B sums
    written once). Returns the counted launches, the kernel's largest
    difference from its plain version and its times."""
    from embeddingtables_tpu_torch.models.dlrm import stacked_flat_indices
    t0 = time.perf_counter()
    with open(MLPERF_DCN_CONFIG) as f:
        js = json.load(f)
    widths = tuple(js["bag_sizes"])
    cfg = ett.DCNConfig(
        vocab_sizes=tuple(js["vocab_sizes"]), num_dense=js["num_dense"],
        dim=js["dim"], num_cross=js["num_cross"], cross_rank=js["cross_rank"],
        deep_mlp=tuple(js["deep_mlp"]), structure=js["structure"],
        bag_sizes=widths, dense_mlp=tuple(js["dense_mlp"]))
    opt = ett.SparseRowWiseAdaGrad(0.01, eps=1e-8, method="indexer")
    model = ett.init_dcn(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         sparse_opt=opt)
    drawn = [zipf_ids(gen, v, w * b, 2)
             for v, w in zip(cfg.vocab_sizes, widths)]
    batches = [{"dense": torch.randn((b, cfg.num_dense), generator=gen,
                                     device="cuda"),
                "cat": torch.cat([d[k].view(w, b)
                                  for d, w in zip(drawn, widths)]),
                "label": torch.randint(0, 2, (b,), generator=gen,
                                       device="cuda").float()}
               for k in range(2)]
    del drawn
    run = ctr_runner(ett.models.dcn.make_train_step(cfg, sparse_opt=opt,
                                                    dense_lr=0.1),
                     model, batches)
    run(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = {"gather_bags_ragged": G.gather_bags_ragged,
                "gather_bags": G.gather_bags, "gather_rows": G.gather_rows,
                "scatter_add_rows_sorted": S.scatter_add_rows_sorted,
                "hot_accumulate": H.hot_accumulate}
    for w in wrappers.values():
        w.launches = 0
    losses = [float(run(i)) for i in range(steps)]
    launches = {k: w.launches for k, w in wrappers.items()}
    require(launches == {"gather_bags_ragged": steps, "gather_bags": 0,
                         "gather_rows": steps,
                         "scatter_add_rows_sorted": steps,
                         "hot_accumulate": 0},
            f"multi-hot DCN launches over {steps} steps: {launches}")
    require(all(math.isfinite(x) for x in losses),
            f"multi-hot DCN losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step = step_times(run, b, steps, hand=MULTIHOT_KERNELS)

    table, d = model.tables.data, cfg.dim
    layout = model.tables.bag_layout(widths)
    id_sets = [stacked_flat_indices(model.tables, x["cat"], None,
                                    widths)[0].view(-1, b) for x in batches]
    got = G.gather_bags_ragged(table, id_sets[0], layout)
    want = G.gather_bags_ragged_plain(table, id_sets[0], layout)
    # The same f32 additions in bag order, one rounding: equal.
    require(torch.equal(got, want), "gather_bags_ragged differs from its "
            "plain version at the MLPerf widths")
    err = max_abs_err(got, want)
    # F.embedding_bag takes each bag's ids together: table t's (w, B) block
    # transposed, bags in (table, example) order, one offset a bag.
    lib_sets = [torch.cat([blk.t().reshape(-1) for blk in
                           torch.split(ids, list(widths))]).long()
                for ids in id_sets]
    offsets = torch.cumsum(torch.tensor(widths, device="cuda")
                           .repeat_interleave(b), 0) - torch.tensor(
                               widths, device="cuda").repeat_interleave(b)
    lib = torch.nn.functional.embedding_bag(lib_sets[0], table, offsets,
                                            mode="sum")
    lib_err = float((lib.view_as(got) - got).abs().max())
    torch.testing.assert_close(lib.view_as(got), got, rtol=1e-5, atol=1e-5)
    del got, want, lib
    n, bags = id_sets[0].numel(), len(widths) * b
    uniq = statistics.mean(int(torch.unique(s).numel()) for s in id_sets)
    nbytes = 4 * n + uniq * d * 4 + bags * d * 4
    t = {"kernel_ms": time_each_ms(
             lambda i: G.gather_bags_ragged(table, i, layout),
             [(s,) for s in id_sets], reps=20),
         "plain_ms": time_each_ms(
             lambda i: G.gather_bags_ragged_plain(table, i, layout),
             [(s,) for s in id_sets], reps=5),
         "library_ms": time_each_ms(
             lambda i: torch.nn.functional.embedding_bag(
                 i, table, offsets, mode="sum"),
             [(s,) for s in lib_sets], reps=20),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    emit({"phase": "multihot_dcn", "seconds": time.perf_counter() - t0,
          "table_shape": list(table.shape), "bag_sizes": list(widths),
          "ids_a_step": n, "bags_a_step": bags, "unique_rows": uniq,
          "bytes": nbytes, "launches": launches, "losses": losses,
          "peak_gb": peak_gb, "kernel_vs_plain_max_abs": err,
          "library_vs_kernel_max_abs": lib_err, **step,
          **{f"gather_bags_ragged_{k}": v for k, v in t.items()}})
    return launches, err, t


def ragged_kernel_row(launches: int, err: float, t: dict) -> dict:
    """The `kernels` line's entry of `gather_bags_ragged`."""
    return {"name": "gather_bags_ragged", "route": "cuda",
            "source": "embeddingtables_tpu_torch/csrc/gather.cu",
            "replaces": None,
            "counterpart": "embeddingtables_tpu/ops/pallas/gather.py:258 "
                           "(bags of one width; per-table widths are the "
                           "port's own)",
            "launches": launches, "max_abs_err": err,
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


# ---------------------------------------------------------------------------
# Phase 11: the table variants
# ---------------------------------------------------------------------------

# The MLPerf DLRM reference's Criteo Terabyte cap (--max-ind-range).
COMPOSITIONAL_ROWS = 40_000_000
COMPOSITIONAL_STEPS = 4
TIERED_HOT_ROWS = (1024, 65_536)
# JAX's own tolerances for quantized scores against f32 ones
# (tests/test_serving.py: int8 rows in test_dlrm_service_matches_direct_eval,
# int4 in test_dlrm_service_int4).
QUANTIZED_TOL = {8: dict(rtol=0.1, atol=0.05), 4: dict(rtol=0.5, atol=0.3)}


def zipf_ids(gen, vocab: int, n: int, k: int, a: float = 1.1) -> list:
    """k sets of n Zipf(a) ids over `vocab` rows, drawn on the card: rank r
    with probability proportional to r^-a (inverse CDF), through one seeded
    random rank -> id permutation, as `SyntheticCriteo` draws them (its
    alias tables take a Python loop over the vocab, too slow at 40M)."""
    p = torch.arange(1, vocab + 1, device="cuda", dtype=torch.float64)
    cdf = torch.cumsum(p.pow_(-a), 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(vocab, generator=gen, device="cuda")
    out = []
    for _ in range(k):
        u = torch.rand(n, generator=gen, device="cuda", dtype=torch.float64)
        rank = torch.searchsorted(cdf, u).clamp_max(vocab - 1)
        out.append(perm[rank].to(torch.int32))
    del p, cdf, perm
    return out


def host_wall_ms(fn, arg_sets, reps: int = 5) -> float:
    """Median host wall time of one call that ends in a synchronize (calls
    that copy to the host wait for the card themselves)."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class swapped_tables:
    """Score `model` with its stacked tables replaced by `data` for the
    length of a block."""

    def __init__(self, model, data):
        self.model, self.data = model, data

    def __enter__(self):
        self.saved, self.model.tables.data = self.model.tables.data, self.data

    def __exit__(self, *exc):
        self.model.tables.data = self.saved


def eval_ms(fn, dense, cat, steps: int = 20) -> float:
    """Device time of one `fn(dense, cat)` at B = 2048: CUDA events over
    `steps` back-to-back calls on device-resident inputs."""
    for _ in range(3):
        fn(dense, cat)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        out = fn(dense, cat)
    end.record()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()), "non-finite logits")
    return start.elapsed_time(end) / steps


def quantized_service_case(ett, G, counter, label, mod, model, make_service,
                           quantize, bits):
    """One quantized service at full width: 8 closed-loop clients, 64
    requests of 1-256 examples, all answered and finite; its scores within
    JAX's own quantized tolerance of the f32 tables' eval (QUANTIZED_TOL)
    and within rtol 1e-5 of the plain dequantize-then-f32 path (the
    dequantized stack through the plain gathers); the stored bytes and the
    eval time at B = 2048 beside the f32 tables'."""
    cfg = model.config
    svc = make_service(model, quantized=True, quantize_bits=bits,
                       max_batch=2048, max_latency_ms=2.0)
    try:
        warm = np.random.default_rng(SEED + 98)
        for b in (1, 256, 2048):
            svc.predict(*make_request(warm, cfg, b), timeout=300)
        t0 = time.perf_counter()
        served, got = counter.run(lambda: closed_loop(
            svc, lambda rng, b: make_request(rng, cfg, b)))
        wall = time.perf_counter() - t0
        stats = svc.stats_snapshot()
    finally:
        svc.stop()
    require(len(served) == 64 and all(
        np.isfinite(o).all() and o.shape == (r[0].shape[0],)
        for r, o, _ in served), f"{label}: non-finite or missing scores")
    sample = served[:16]
    dense = torch.from_numpy(np.concatenate([r[0] for r, _, _ in sample]))
    cat = torch.from_numpy(np.concatenate([r[1] for r, _, _ in sample],
                                          axis=1))
    service = np.concatenate([o for _, o, _ in sample])
    qt, eval_fn = quantize(model, bits=bits)
    quant = eval_fn(dense, cat)
    ev = mod.make_eval_step(cfg)
    f32 = ev(model, dense, cat)
    # The service's scores against the f32 tables' on the same requests,
    # and the quantized eval of those requests, batched as one.
    tol = QUANTIZED_TOL[bits]
    np.testing.assert_allclose(service, f32.cpu().numpy(), **tol)
    torch.testing.assert_close(quant, f32, **tol)
    with swapped_tables(model, qt.dequantize()), plain_gathers(G):
        plain = ev(model, dense, cat)
    torch.testing.assert_close(quant, plain, rtol=1e-5, atol=1e-6)
    d, c = make_request(np.random.default_rng(SEED + 5), cfg, 2048)
    d, c = torch.from_numpy(d).cuda(), torch.from_numpy(c).cuda()
    table = model.tables.data
    out = {"phase": "quantized_serve", "model": label, "bits": bits,
           "tolerance_vs_f32": tol,
           "requests": len(served), "wall_s": wall, "launches": got,
           **latency_ms([lat for _, _, lat in served]),
           "batches": stats["batches"],
           "nbytes": qt.nbytes,
           "f32_nbytes": table.numel() * table.element_size(),
           "eval_ms_b2048": eval_ms(eval_fn, d, c),
           "f32_eval_ms_b2048": eval_ms(lambda x, y: ev(model, x, y), d, c),
           "vs_f32_max_abs": max_abs_err(quant, f32),
           "service_vs_f32_max_abs": float(np.abs(
               service - f32.cpu().numpy()).max()),
           "vs_plain_dequantized_max_abs": max_abs_err(quant, plain),
           "max_abs_logit": float(f32.abs().max())}
    emit(out)
    del qt, eval_fn
    torch.cuda.empty_cache()
    return out


def quantized_gather_times(G, gen, qt, f32_table, bits, n=26 * 2048):
    """The quantized gather (`rows`: two `index_select`s, the unpack, one
    multiply) at the serving shape beside its byte bound: each unique row's
    stored bytes and scale read once, the ids read, the f32 rows written;
    and `gather_rows` on the f32 table."""
    v, d = f32_table.shape
    sets = [torch.randint(0, v, (n,), generator=gen, device="cuda",
                          dtype=torch.int32) for _ in range(10)]
    uniq = statistics.mean(torch.unique(s).numel() for s in sets)
    row_bytes = d if bits == 8 else d // 2
    nbytes = uniq * (row_bytes + 4) + n * 4 + n * d * 4
    t = {"kernel_ms": time_each_ms(lambda i: qt.rows(i), [(s,) for s in sets]),
         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
         "f32_gather_rows_ms": time_each_ms(
             lambda i: G.gather_rows(f32_table, i), [(s,) for s in sets])}
    emit({"phase": "quantized_gather_time", "bits": bits, "V": v, "D": d,
          "n": n, "unique_rows": uniq, "bytes": nbytes, **t,
          "share_of_bound": t["bound_ms"] / t["kernel_ms"]})


def quantized_phase(ett, G, counter, gen):
    """int8 and int4 serving of the 26 x 250,000 x 128 DLRM, int8 DCN-v2,
    int8 folded DeepFM (int4 refused on its odd width), int4 unfolded
    DeepFM, and a bag-8 batch through the quantized DLRM beside its f32
    reference through `gather_bags`."""
    from embeddingtables_tpu_torch import quant
    M = ett.models
    out = {}
    cfg = ett.dlrm_small_config(vocab=VOCAB)
    model = ett.init_dlrm(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    for bits in (8, 4):
        out[f"dlrm_int{bits}"] = quantized_service_case(
            ett, G, counter, "dlrm", M.dlrm, model, ett.make_dlrm_service,
            quant.quantize_dlrm, bits)
        qt, _ = quant.quantize_dlrm(model, bits=bits)
        quantized_gather_times(G, gen, qt, model.tables.data, bits)
        del qt
    # A bag-8 batch: the quantized eval beside the f32 eval (one
    # gather_bags launch) and the plain dequantized path, f32 towers (bag
    # sums in another f32 order would flip bf16 roundings).
    cfgb = dataclasses.replace(cfg, bag=8, compute_dtype=torch.float32)
    db, cb = make_request(np.random.default_rng(SEED + 7), cfgb, 2048, 8)
    db, cb = torch.from_numpy(db).cuda(), torch.from_numpy(cb).cuda()
    with config_as(model, cfgb):
        qt, eval_fn = quant.quantize_dlrm(model, bits=8)
        qb, _ = counter.run(lambda: eval_fn(db, cb))
        fb, gotb = counter.run(lambda: M.dlrm.make_eval_step(cfgb)(
            model, db, cb))
        with swapped_tables(model, qt.dequantize()), plain_gathers(G):
            pb = M.dlrm.make_eval_step(cfgb)(model, db, cb)
    require(gotb["gather_bags"] == 1, f"bag-8 f32 launches {gotb}")
    torch.testing.assert_close(qb, fb, **QUANTIZED_TOL[8])
    torch.testing.assert_close(qb, pb, rtol=1e-5, atol=1e-6)
    emit({"phase": "quantized_bag8", "batch": 2048, "bag": 8,
          "f32_launches": gotb, "vs_f32_max_abs": max_abs_err(qb, fb),
          "vs_plain_dequantized_max_abs": max_abs_err(qb, pb)})
    stack = model.tables.data
    del model, qt, eval_fn
    torch.cuda.empty_cache()

    model = ett.init_dcn(ett.dcn_small_config(vocab=VOCAB),
                         torch.Generator(device="cuda").manual_seed(SEED))
    out["dcn_int8"] = quantized_service_case(
        ett, G, counter, "dcn", M.dcn, model, ett.make_dcn_service,
        quant.quantize_dcn, 8)
    del model
    torch.cuda.empty_cache()

    fm_cfg = ett.deepfm_small_config(vocab=VOCAB)
    model = ett.init_deepfm(fm_cfg, torch.Generator(device="cuda")
                            .manual_seed(SEED))
    out["deepfm_folded_int8"] = quantized_service_case(
        ett, G, counter, "deepfm_folded", M.deepfm, model,
        ett.make_deepfm_service, quant.quantize_deepfm, 8)
    try:
        ett.make_deepfm_service(model, quantized=True, quantize_bits=4)
    except ValueError as e:
        refused = str(e)
    else:
        raise SystemExit("chip_smoke: FAILED: int4 on the folded (D + 1 = "
                         "129) stack was not refused")
    emit({"phase": "quantized_refusal", "model": "deepfm_folded", "bits": 4,
          "error": refused})
    del model
    torch.cuda.empty_cache()
    model = ett.init_deepfm(dataclasses.replace(fm_cfg, fold_fm_w=False),
                            torch.Generator(device="cuda").manual_seed(SEED))
    out["deepfm_unfolded_int4"] = quantized_service_case(
        ett, G, counter, "deepfm_unfolded", M.deepfm, model,
        ett.make_deepfm_service, quant.quantize_deepfm, 4)
    del model
    torch.cuda.empty_cache()
    return stack


def compositional_step(kind, table, opt, ids, target):
    """One SGD step of a 40M-row compositional table: its `*_lookup_vjp` on
    `ids`, the mean-squared-error cotangent toward `target`, and
    `opt.apply` on every sparse sub-table (MD's projection by dense SGD).
    Returns the loss."""
    from embeddingtables_tpu_torch import md, qr, tt
    vjp = {"qr": qr.qr_lookup_vjp, "md": md.md_lookup_vjp,
           "tt": tt.tt_lookup_vjp}[kind]
    out, pull = vjp(table, ids)
    err = out - target
    upds = pull(err / ids.numel())
    if kind == "md":
        upds, proj_grad = upds[:1], upds[1]
        table.proj.sub_(opt.lr * proj_grad)
    for data, upd in zip(sub_tables(kind, table), upds):
        opt.apply(data, upd, opt.init(data))
    return 0.5 * (err * err).sum(1).mean()


def sub_tables(kind, table) -> list:
    if kind == "qr":
        return [table.q_data, table.r_data]
    if kind == "md":
        return [table.data]
    return list(table.core_tables())


def compositional_phase(ett, S, H, G, counter, gen):
    """QR (mult, Q = int(sqrt(V))), MD (d_small = 32) and TT (rank 8, 3
    cores) at one table of 40,000,000 rows x 128, the settings JAX defaults
    to: one SGD step through the kernels against the plain versions, then
    COMPOSITIONAL_STEPS steps at B = 65,536 on Zipf(1.1) ids with the
    kernel launches counted, and the lookup's time beside `gather_rows` on
    a dense table of the same rows and width."""
    import copy
    v, d = COMPOSITIONAL_ROWS, 128
    ids = zipf_ids(gen, v, B_TRAIN, COMPOSITIONAL_STEPS)
    target = torch.randn((B_TRAIN, d), generator=gen, device="cuda") * 0.1
    dense = torch.empty((v, d), device="cuda")
    dense.uniform_(-1.0, 1.0, generator=gen)
    uniq = statistics.mean(torch.unique(s).numel() for s in ids)
    dense_ms = time_each_ms(lambda i: G.gather_rows(dense, i),
                            [(s,) for s in ids], reps=20)
    dense_plain_ms = time_each_ms(lambda i: G.gather_rows_plain(dense, i),
                                  [(s,) for s in ids], reps=20)
    dense_library_ms = time_each_ms(
        lambda i: torch.nn.functional.embedding(i, dense),
        [(s.long(),) for s in ids], reps=20)
    del dense
    torch.cuda.empty_cache()
    emit({"phase": "compositional_dense_gather", "V": v, "D": d,
          "n": B_TRAIN, "unique_rows": uniq, "gather_rows_ms": dense_ms,
          "plain_ms": dense_plain_ms, "library_ms": dense_library_ms,
          "bound_ms": (uniq * d * 4 + B_TRAIN * 4 + B_TRAIN * d * 4)
          / HBM_BYTES_PER_S * 1e3})
    opt = ett.SparseSGD(0.5)
    out = {}
    for kind in ("qr", "md", "tt"):
        r0 = time.perf_counter()
        g = torch.Generator(device="cuda").manual_seed(SEED)
        if kind == "qr":
            table = ett.QREmbedding.create(g, v, d)
        elif kind == "md":
            table = ett.MDEmbedding.create(g, v, d, 32)
        else:
            table = ett.TTEmbedding.create(g, v, d, rank=8, num_cores=3)
        subs = sub_tables(kind, table)
        # Sub-tables of at most 512 padded rows and a width of a multiple
        # of 128 take hot_accumulate (`optim._segsum_vpad`, JAX's rule): TT's
        # 342-row middle core, 256 wide.
        tiny = [t.shape[1] % 128 == 0 and -(-t.shape[0] // 128) * 128 <= 512
                for t in subs]
        plain = copy.deepcopy(table)
        compositional_step(kind, table, opt, ids[0], target)
        with plain_kernels(S, G), plain_gathers(G), plain_segsum(H):
            compositional_step(kind, plain, opt, ids[0], target)
        torch.cuda.synchronize()
        errs = []
        for a, b, is_tiny in zip(subs, sub_tables(kind, plain), tiny):
            if is_tiny:
                # hot_accumulate sums in another order than its plain
                # version (its stated tolerance, 1e-5 of the sums).
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            else:
                require(torch.equal(bits(a), bits(b)),
                        f"{kind}: the SGD step is not bitwise the plain path")
            errs.append(max_abs_err(a, b))
        if kind == "md":
            torch.testing.assert_close(table.proj, plain.proj, rtol=1e-5,
                                       atol=1e-6)
        del plain
        torch.cuda.empty_cache()
        losses, got = counter.run(lambda: [
            float(compositional_step(kind, table, opt, ids[i], target))
            for i in range(COMPOSITIONAL_STEPS)])
        require(all(math.isfinite(x) for x in losses),
                f"{kind}: non-finite losses {losses}")
        runs = COMPOSITIONAL_STEPS * sum(not t for t in tiny)
        hots = COMPOSITIONAL_STEPS * sum(tiny)
        require(got["scatter_add_rows_sorted"] == runs
                and got["hot_accumulate"] == hots,
                f"{kind}: launches {got}, want {runs} run-scatters and "
                f"{hots} hot_accumulate")
        rows_ms = time_each_ms(lambda i: table.rows(i), [(s,) for s in ids],
                               reps=20)
        step_ms = events_ms(lambda: compositional_step(
            kind, table, opt, ids[0], target), reps=3)
        out[kind] = {"rows_ms": rows_ms, "step_ms": statistics.median(step_ms)}
        emit({"phase": "compositional", "kind": kind, "V": v, "D": d,
              "sub_tables": [list(t.shape) for t in subs],
              "hot_accumulate_sub_tables": tiny,
              "compression": table.compression(),
              "parity_max_abs_err": errs,
              "parity": ["rtol 1e-5 (hot_accumulate)" if t else "bitwise"
                         for t in tiny],
              "steps": COMPOSITIONAL_STEPS, "batch": B_TRAIN,
              "losses": losses, "launches": got, "rows_ms": rows_ms,
              "dense_gather_rows_ms": dense_ms,
              "step_ms": out[kind]["step_ms"],
              "seconds": time.perf_counter() - r0})
        del table, subs
        torch.cuda.empty_cache()
    return out


def host_memory_gb() -> dict:
    with open("/proc/meminfo") as f:
        info = {ln.split(":")[0]: int(ln.split()[1]) for ln in f}
    return {"host_total_gb": info["MemTotal"] / 2**20,
            "host_available_gb": info["MemAvailable"] / 2**20}


def host_tables_phase(ett, G, counter, stack, batches):
    """The stacked DLRM's (6.5M, 128) f32 stack offloaded to pinned host
    memory, then tiered after a `FrequencyTracker` relayout on the training
    batches with hot_rows = 1,024 and 65,536: lookups of the training ids
    bitwise a `SimpleEmbedding` on the card, updates within rtol 1e-6 (the
    host adds each row's deltas in stream order, the card under
    deterministic algorithms), the copies and lookups timed."""
    from embeddingtables_tpu_torch.utils import rowstats
    mem = host_memory_gb()
    emit({"phase": "host_memory", **mem,
          "stack_gb": stack.numel() * 4 / 1e9})
    require(mem["host_available_gb"] > 24,
            f"too little host memory to pin the stack: {mem}")
    v, d = stack.shape
    flat = [stacked_rows(b, VOCAB) for b in batches[:2]]
    n = flat[0].numel()
    delta = torch.randn((n, d), generator=torch.Generator(device="cuda")
                        .manual_seed(SEED + 9), device="cuda") * 1e-3

    def check(label, table, ref, id_sets):
        ids = id_sets[0]
        got, launched = counter.run(lambda: table.rows(ids))
        require(torch.equal(bits(got), bits(ref.rows(ids))),
                f"{label}: lookup not bitwise the SimpleEmbedding's")
        rows_ms = host_wall_ms(table.rows, [(i,) for i in id_sets])
        # Deterministic algorithms: index_add_ on the card otherwise adds a
        # hot row's thousands of deltas in a varying order.
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            table.scatter_apply(ids, delta)
            ref.scatter_apply(ids, delta)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        whole = table.materialize()
        torch.testing.assert_close(whole, ref.data, rtol=1e-6, atol=1e-6)
        err = max_abs_err(whole, ref.data)
        del whole
        update_ms = host_wall_ms(table.scatter_apply, [(ids, delta)], reps=2)
        return {"launches": launched, "rows_ms": rows_ms,
                "update_ms": update_ms, "update_max_abs_err": err,
                "simple_rows_ms": host_wall_ms(ref.rows,
                                               [(i,) for i in id_sets])}

    t0 = time.perf_counter()
    off = ett.HostOffloadEmbedding(stack)
    require(off.data.is_pinned(), "the offloaded table is not pinned")
    pin_s = time.perf_counter() - t0
    ref = ett.SimpleEmbedding(stack.clone())
    res = check("offload", off, ref, flat)
    # The copies of one lookup: the ids to the host, the rows to the card.
    rows_host = torch.empty((n, d), pin_memory=True)
    copies = {
        "ids_to_host_ms": host_wall_ms(lambda i: i.to("cpu"),
                                       [(i,) for i in flat]),
        "host_gather_ms": host_wall_ms(
            lambda i: torch.index_select(off.data, 0, i, out=rows_host),
            [(i.cpu().long(),) for i in flat]),
        "rows_to_card_ms": time_each_ms(
            lambda r: r.to("cuda", non_blocking=True), [(rows_host,)],
            reps=10)}
    row_bytes = n * d * 4
    emit({"phase": "offload", "V": v, "D": d, "n": n, "pin_s": pin_s,
          **res, **copies,
          "rows_to_card_gb_per_s": row_bytes / copies["rows_to_card_ms"]
          / 1e6})
    del off, ref, rows_host
    torch.cuda.empty_cache()

    tracker = rowstats.FrequencyTracker(v)
    for b in batches:
        tracker.observe(stacked_rows(b, VOCAB).cpu().numpy())
    perm = tracker.frequency_permutation()
    inv = torch.from_numpy(rowstats.inverse_permutation(perm)).cuda()
    relaid = rowstats.relayout(stack, perm)
    remapped = [inv[i.long()].to(torch.int32) for i in flat]
    out = {}
    for hot_rows in TIERED_HOT_ROWS:
        t0 = time.perf_counter()
        tiered = ett.TieredEmbedding.from_array(relaid, hot_rows)
        split_s = time.perf_counter() - t0
        ref = ett.SimpleEmbedding(relaid.clone())
        res = check(f"tiered {hot_rows}", tiered, ref, remapped)
        require(res["launches"]["gather_rows"] == 1,
                f"tiered: hot gather launches {res['launches']}")
        out[hot_rows] = {"hot_fraction": tiered.hot_fraction(remapped[0]),
                         "coverage": tracker.coverage(hot_rows), **res}
        emit({"phase": "tiered", "V": v, "D": d, "n": n,
              "hot_rows": hot_rows, "split_s": split_s, **out[hot_rows]})
        del tiered, ref
        torch.cuda.empty_cache()
    del relaid
    torch.cuda.empty_cache()
    return out


def eviction_phase(ett, S, counter, batches):
    """`train_dlrm(evict_every=2)` on the 26 x 250,000 DLRM at B = 65,536,
    SGD and indexer AdaGrad, 8 steps on host batches: evicted rows > 0, as
    many as a tracker replayed beside the loop pops, and the rows of the
    last eviction zero in the table and in the AdaGrad accumulator."""
    import copy
    from embeddingtables_tpu_torch.utils import rowstats
    cfg = ett.dlrm_small_config(vocab=VOCAB)
    host = [{k: t.cpu().numpy() for k, t in b.items()} for b in batches]
    steps, every, threshold, decay = 8, 2, 0.3, 0.5
    out = {}
    for name, opt in (("sgd", ett.SparseSGD(1e-4)),
                      ("adagrad_indexer",
                       ett.SparseRowWiseAdaGrad(1e-3, method="indexer"))):
        model = ett.init_dlrm(cfg, torch.Generator(device="cuda")
                              .manual_seed(SEED), sparse_opt=opt)
        # The same loop on the same host batches without eviction, first
        # (it also warms the step), for the rate eviction costs.
        plain_rate = ett.train_dlrm(
            cfg, itertools.cycle(host), steps, sparse_opt=opt, dense_lr=0.1,
            model=copy.deepcopy(model), log_every=1,
            verbose=False).examples_per_sec
        torch.cuda.empty_cache()
        res, got = counter.run(lambda: ett.train_dlrm(
            cfg, itertools.cycle(host), steps, sparse_opt=opt, dense_lr=0.1,
            model=model, evict_every=every, evict_threshold=threshold,
            freq_decay=decay, log_every=1, verbose=False))
        # The loop's trackers, replayed.
        trackers = [rowstats.FrequencyTracker(VOCAB, decay)
                    for _ in range(26)]
        popped, last = 0, None
        for i in range(steps):
            for t, tr in enumerate(trackers):
                tr.observe(host[i % len(host)]["cat"][t])
            if (i + 1) % every == 0:
                last = np.concatenate([tr.pop_cold(threshold) + t * VOCAB
                                       for t, tr in enumerate(trackers)])
                popped += last.size
        require(res.evicted_rows == popped > 0 and last.size > 0,
                f"{name}: evicted {res.evicted_rows}, replay {popped}")
        require(got["scatter_add_rows_sorted"] == steps,
                f"{name}: launches {got}")
        rows = torch.from_numpy(last.astype(np.int64)).cuda()
        require(not model.tables.data[rows].any(),
                f"{name}: evicted rows not zero")
        if name != "sgd":
            require(not model.emb_state.accum[rows].any(),
                    f"{name}: evicted accumulators not zero")
        require(all(math.isfinite(x) for x in res.losses),
                f"{name}: non-finite losses")
        out[name] = {"evicted_rows": res.evicted_rows,
                     "last_eviction_rows": int(last.size)}
        emit({"phase": "eviction", "recipe": name, "steps": steps,
              "evict_every": every, "evict_threshold": threshold,
              "freq_decay": decay, "evicted_rows": res.evicted_rows,
              "last_eviction_rows": int(last.size), "launches": got,
              "losses": res.losses,
              "train_examples_per_s": res.examples_per_sec,
              "without_eviction_examples_per_s": plain_rate})
        del model, res
        torch.cuda.empty_cache()
    return out


def variants_phase(ett, S, H, G, gen, batches):
    """The table variants: quantized serving, the compositional tables at
    40M rows, the offloaded and tiered stack, and row eviction in the loop.
    Returns the launches of each kernel in the counted runs."""
    t0 = time.perf_counter()
    counter = LaunchCounter(S, H, G)
    stack = quantized_phase(ett, G, counter, gen)
    host_tables_phase(ett, G, counter, stack, batches)
    del stack
    torch.cuda.empty_cache()
    compositional_phase(ett, S, H, G, counter, gen)
    eviction_phase(ett, S, counter, batches)
    emit({"phase": "variants_done", "seconds": time.perf_counter() - t0,
          "launches": counter.total})
    return counter.total


# ---------------------------------------------------------------------------
# Phase 12: the run-scatter on rows wider than its registers
# ---------------------------------------------------------------------------

WIDE_WIDTHS = (258, 1025, 2048, 4096)
WIDE_ROWS = 100_000                # table rows at each wide width
TT_RANK_WIDE = 32                  # TT's middle core at rank 32: 4,096 wide


def time_wide_scatter(S, gen, sets, v, d, label="zipf"):
    """The run-scatter at one width on sorted streams (Zipf), f32 table,
    SGD and AdaGrad epilogues: each set's kernel result held to the plain
    version's on clones of the table (`scatter_agrees`), kernel and plain
    times, `index_add_` (SGD's function in one library call; AdaGrad has
    none), and the byte bound n*D*4 + n*4 + 2*U*D*4 (+ 2*U*4 for the
    accumulator)."""
    table = torch.randn((v, d), generator=gen, device="cuda") * 0.05
    accum = torch.rand((v,), generator=gen, device="cuda")
    n = sets[0][0].numel()
    uniq = statistics.mean(int(torch.unique(r).numel()) for r, _ in sets)
    out = {}
    for epilogue in ("sgd", "adagrad"):
        a = accum if epilogue == "adagrad" else None
        err = 0.0
        for r, x in sets:
            tk, tp = table.clone(), table.clone()
            ak, ap = (None, None) if a is None else (a.clone(), a.clone())
            S.scatter_add_rows_sorted(tk, r, x, -1e-4, accum=ak, eps=1e-8)
            S.scatter_add_rows_sorted_plain(tp, r, x, -1e-4, accum=ap,
                                            eps=1e-8)
            err = max(err, scatter_agrees(
                tk, tp, ak, ap, f"scatter {label} D={d} {epilogue}"))
            del tk, tp, ak, ap
        nbytes = (n * d * 4 + n * 4 + 2 * uniq * d * 4
                  + (2 * uniq * 4 if a is not None else 0))
        bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = (n * d + 2 * uniq * d
                        + (2 * uniq * d if a is not None else 0)) \
            / F32_OPS_PER_S * 1e3
        t = {"kernel_ms": time_each_ms(
                lambda r, x: S.scatter_add_rows_sorted(
                    table, r, x, -1e-4, accum=a, eps=1e-8), sets, reps=10),
             "plain_ms": time_each_ms(
                lambda r, x: S.scatter_add_rows_sorted_plain(
                    table, r, x, -1e-4, accum=a, eps=1e-8), sets, reps=3),
             "library_ms": None if a is not None else time_each_ms(
                lambda r, x: table.index_add_(0, r, x, alpha=-1e-4),
                [(r.long(), x) for r, x in sets], reps=10),
             "bound_ms": max(bound_bytes_ms, bound_ops_ms),
             "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                          else "operations"),
             "max_abs_err": err,
             "kernel_split_us": [[k[:60], us] for k, us in device_kernels(
                 lambda: S.scatter_add_rows_sorted(
                     table, *sets[0], -1e-4, accum=a, eps=1e-8))]}
        emit({"phase": "kernel_time", "kernel": "scatter_add_rows_sorted",
              "stream": label, "epilogue": epilogue, "dtype": "float32",
              "V": v, "D": d, "n": n, "unique_rows": uniq, "bytes": nbytes,
              **t})
        out[epilogue] = t
    del table, accum
    return out


def tt_rank32_step(ett, S, G, counter, gen):
    """TT at rank 32 on the 40M-row table (cores 256, 4,096 and 128 wide,
    342 rows each): `SparseRowWiseAdaGrad(method="indexer")` sends every
    core to the run-scatter, the middle core on the wide path. One step
    against the plain step (rtol 1e-6), then COMPOSITIONAL_STEPS counted
    steps. Returns the counted launches."""
    import copy
    v, d = COMPOSITIONAL_ROWS, 128
    ids = zipf_ids(gen, v, B_TRAIN, COMPOSITIONAL_STEPS)
    target = torch.randn((B_TRAIN, d), generator=gen, device="cuda") * 0.1
    opt = ett.SparseRowWiseAdaGrad(0.05, method="indexer")
    table = ett.TTEmbedding.create(
        torch.Generator(device="cuda").manual_seed(SEED), v, d,
        rank=TT_RANK_WIDE, num_cores=3)
    plain = copy.deepcopy(table)
    compositional_step("tt", table, opt, ids[0], target)
    with plain_kernels(S, G), plain_gathers(G):
        compositional_step("tt", plain, opt, ids[0], target)
    torch.cuda.synchronize()
    errs = []
    for a, b in zip(table.core_tables(), plain.core_tables()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
        errs.append(max_abs_err(a, b))
    del plain
    losses, got = counter.run(lambda: [
        float(compositional_step("tt", table, opt, ids[i], target))
        for i in range(COMPOSITIONAL_STEPS)])
    require(all(math.isfinite(x) for x in losses),
            f"TT rank {TT_RANK_WIDE}: non-finite losses {losses}")
    require(got["scatter_add_rows_sorted"] == 3 * COMPOSITIONAL_STEPS
            and got["hot_accumulate"] == 0,
            f"TT rank {TT_RANK_WIDE}: launches {got}")
    step_ms = events_ms(lambda: compositional_step("tt", table, opt, ids[0],
                                                   target), reps=3)
    emit({"phase": "tt_rank32_adagrad", "V": v, "D": d,
          "rank": TT_RANK_WIDE,
          "core_tables": [list(t.shape) for t in table.core_tables()],
          "parity_max_abs_err": errs, "parity": "rtol 1e-6",
          "losses": losses, "launches": got,
          "step_ms": statistics.median(step_ms)})
    del table
    torch.cuda.empty_cache()
    return got


def wide_rows_phase(ett, S, G, gen, counter):
    """The run-scatter at D = 258, 1,025, 2,048 and 4,096 (the wide class:
    a block a window), f32 and bf16 tables, SGD
    (bitwise) and AdaGrad (rtol 1e-6) epilogues, on a window-edge stream and
    a Zipf stream, each held to its plain version and timed; then TT at
    rank 32 under indexer AdaGrad. Returns (max error, {D: times},
    launches of the counted TT steps)."""
    t0 = time.perf_counter()
    err, times = 0.0, {}
    v, n = WIDE_ROWS, B_TRAIN
    for d in WIDE_WIDTHS:
        zipf = [torch.sort(z, stable=True).values
                for z in zipf_ids(gen, v, n, 3)]
        edges = window_edge_stream(S.RUN_WINDOW, v, reps=10)
        err = max(err, check_scatter(
            S, gen, {"zipf": with_padding(zipf[0], v, gen),
                     "window_edges": edges}, v, d))
        sets = [(z, torch.randn((n, d), generator=gen, device="cuda"))
                for z in zipf]
        times[d] = time_wide_scatter(S, gen, sets, v, d)
        err = max(err, *(t["max_abs_err"] for t in times[d].values()))
        del zipf, edges, sets
        torch.cuda.empty_cache()
    launches = tt_rank32_step(ett, S, G, counter, gen)
    emit({"phase": "wide_rows_done", "seconds": time.perf_counter() - t0})
    return err, times, launches


# ---------------------------------------------------------------------------
# Phase 12, part 2: the run-scatter at every width class
# ---------------------------------------------------------------------------

# Narrow (D = 1 ... 64), 32-128 units (128) and wide (129 ... 4,096). D = 4
# and 8 are one and two 16-byte units (P = 1 and 2), D = 2 and 7 4-byte units.
SCATTER_WIDTHS = (1, 2, 4, 7, 8, 12, 16, 32, 36, 64, 128, 129, 258, 1025,
                  2048, 4096)


def hot_run_stream(gen, v: int, n: int) -> torch.Tensor:
    """n sorted Zipf ids over v rows, a third of them one row (a run over
    n / 3L windows), with padding and rows >= V (`with_padding`)."""
    (z,) = zipf_ids(gen, v, n, 1)
    r = torch.rand(n, generator=gen, device="cuda")
    return with_padding(torch.where(r < 1 / 3, v // 2, z), v, gen)


def device_kernels(fn) -> list:
    """[name, µs] of each device kernel one call of `fn` launches
    (torch.profiler), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [[e.name, e.time_range.elapsed_us()] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def kernels_per_call(S, gen, d: int, adagrad: bool, v: int = WIDE_ROWS,
                     n: int = B_TRAIN) -> tuple:
    """The kernels one wrapper call launches, on 65,536 sorted Zipf ids
    over `v` rows: the launch code's count (`scatter_add_rows_sorted.kernels`,
    which the entry point reports; None in a build without it) and the
    device kernels torch.profiler recorded, [name, µs] each (late in the
    whole script the profiler has recorded none, and once it dropped one)."""
    (rows,) = zipf_ids(gen, v, n, 1)
    rows = torch.sort(rows).values
    table = torch.zeros((v, d), device="cuda")
    vals = torch.randn((n, d), generator=gen, device="cuda")
    accum = torch.zeros((v,), device="cuda") if adagrad else None
    recorded = device_kernels(lambda: S.scatter_add_rows_sorted(
        table, rows, vals, -1e-4, accum=accum, eps=1e-8))
    return getattr(S.scatter_add_rows_sorted, "kernels", None), recorded


def scatter_widths_phase(ett, S, gen):
    """The run-scatter at every width of SCATTER_WIDTHS (D = 1 ... 4,096),
    f32 and bf16 tables, SGD (bitwise) and AdaGrad (rtol 1e-6; bf16 2^-7)
    against its plain version on a window-edge stream, a padded Zipf stream
    and a stream whose hottest run spans about 170 windows (65,536 ids over
    100,000 rows); the kernels one wrapper call launches at D = 1, 258,
    1,025 and 4,096 (the launch code's count, torch.profiler's record beside
    it); then each width timed beside its byte bound and `index_add_` on its
    path's stream, each timed set's result held to the plain version's: the
    stacked training ids (1,703,936 Zipf ids over 26 x 250,000 rows) at
    D = 1, 128 and 129; the two-tower tables at D = 64 (the query stack's
    3 x 16,384 ids over 1.1M rows, the corpus's 16,384 over 2M); the mixed
    replicated group at D = 32 (1,048,576 ids over 19,889 rows); 65,536 Zipf
    ids over 100,000 rows at the other widths. Returns (max error,
    {key: times})."""
    t0 = time.perf_counter()
    err, v, n = 0.0, WIDE_ROWS, B_TRAIN
    for d in SCATTER_WIDTHS:
        (z,) = zipf_ids(gen, v, n, 1)
        err = max(err, check_scatter(
            S, gen, {"window_edges": window_edge_stream(S.RUN_WINDOW, v,
                                                        reps=10),
                     "zipf": with_padding(z, v, gen),
                     "hot_run": hot_run_stream(gen, v, n)}, v, d))
        torch.cuda.empty_cache()
    emit({"phase": "scatter_widths_checks", "widths": list(SCATTER_WIDTHS),
          "max_abs_err": err, "seconds": time.perf_counter() - t0})
    launched = {}
    for d in (1, 258, 1025, 4096):
        for adagrad in (False, True):
            counted, recorded = kernels_per_call(S, gen, d, adagrad)
            names = [x for x, _ in recorded]
            hand = [x for x in names if HAND_KERNELS[
                "scatter_add_rows_sorted"] in x]
            launched[f"d{d}_{'adagrad' if adagrad else 'sgd'}"] = counted
            emit({"phase": "scatter_kernels_per_call", "D": d,
                  "epilogue": "adagrad" if adagrad else "sgd",
                  "run_scatter_kernels": counted,
                  "profiler_run_scatter_kernels": len(hand) if names else None,
                  "device_kernels": [x[:80] for x in names]})
    torch.cuda.empty_cache()

    def sorted_sets(row_sets, d):
        return [(torch.sort(r.to(torch.int32)).values,
                 torch.randn((r.numel(), d), generator=gen, device="cuda"))
                for r in row_sets]
    stacked = [stacked_rows(b, VOCAB) for b in
               criteo_batches(ett, (VOCAB,) * 26, 3, SEED + 5)]
    tt = list(ett.SyntheticRetrieval(
        TT_QUERY_VOCABS, TT_ITEMS, num_dense=4, batch_size=TT_BATCH,
        seed=SEED + 20).batches(3))
    q_off = np.cumsum([0] + list(TT_QUERY_VOCABS[:-1]))[:, None]
    small = [i for i, c in enumerate(PLANNER_VOCABS) if c <= MIXED_SMALL]
    m_off = np.cumsum([0] + [PLANNER_VOCABS[i] for i in small])
    mixed = [np.stack([b["cat"][i] + m_off[j] for j, i in enumerate(small)])
             for b in ett.SyntheticCriteo(vocab_sizes=PLANNER_VOCABS,
                                          batch_size=B_TRAIN,
                                          seed=SEED + 41).batches(3)]

    def cuda_ids(x):
        return torch.from_numpy(np.ascontiguousarray(x).reshape(-1).astype(
            np.int32)).cuda()
    # key: (label, rows of the table, the id sets)
    streams = {
        "stacked": (26 * VOCAB, stacked),
        "tt_query": (sum(TT_QUERY_VOCABS),
                     [cuda_ids(b["q_cat"] + q_off) for b in tt]),
        "tt_items": (TT_ITEMS, [cuda_ids(b["item_ids"]) for b in tt]),
        "mixed": (int(m_off[-1]), [cuda_ids(m) for m in mixed]),
        "zipf_100k": (v, None)}
    cases = [("stacked", 1), ("stacked", 128), ("stacked", 129),
             ("tt_query", 64), ("tt_items", 64), ("mixed", 32)] + [
        ("zipf_100k", d) for d in (4, 7, 8, 36, 258, 1025, 2048, 4096)]
    times = {}
    for label, d in cases:
        rows_v, id_sets = streams[label]
        if id_sets is None:
            id_sets = zipf_ids(gen, rows_v, n, 3)
        t = times[f"{label}_d{d}"] = time_wide_scatter(
            S, gen, sorted_sets(id_sets, d), rows_v, d, label)
        err = max(err, *(x["max_abs_err"] for x in t.values()))
        torch.cuda.empty_cache()
    emit({"phase": "scatter_widths_times",
          "kernels_per_call": launched,
          **{k: {e: {"kernel_ms": t[e]["kernel_ms"],
                     "bound_ms": t[e]["bound_ms"],
                     "share_of_bound": t[e]["bound_ms"] / t[e]["kernel_ms"],
                     "library_ms": t[e]["library_ms"],
                     "kernel_over_library": (
                         None if t[e]["library_ms"] is None
                         else t[e]["kernel_ms"] / t[e]["library_ms"])}
                 for e in ("sgd", "adagrad")} for k, t in times.items()},
          "seconds": time.perf_counter() - t0})
    return err, times, launched


# ---------------------------------------------------------------------------
# Phase 13: persistence at full width
# ---------------------------------------------------------------------------

PERSIST_VOCAB = 250_000            # the stacked DLRM: 26 x 250,000 x 128
PERSIST_STEPS = 8


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def model_bytes(model) -> int:
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())


class recorded_saves:
    """Wrap a `DeltaCheckpointManager`'s `save` to record each save's step,
    kind (base or delta), touched rows and bytes on disk."""

    def __init__(self, mgr):
        self.mgr, self.saves, self.inner = mgr, [], mgr.save
        mgr.save = self

    def __call__(self, step, data, state, tracker):
        rows = tracker.count()
        path = self.inner(step, data, state, tracker)
        kind = "base" if os.path.basename(path).startswith("base_") \
            else "delta"
        self.saves.append({"step": step, "kind": kind, "touched_rows": rows,
                           "bytes": dir_bytes(path) if kind == "base"
                           else os.path.getsize(path)})
        return path


def phase_spans(tel, name: str) -> list:
    """Record the wall time of every `name` phase through the telemetry's
    callbacks; returns the list the durations (ms) land in."""
    spans, start = [], {}

    def cb(phase_name, event):
        if phase_name != name:
            return
        if event == "start":
            start["t"] = time.perf_counter()
        else:
            spans.append((time.perf_counter() - start["t"]) * 1e3)

    tel.on_phase(cb)
    return spans


def served_batches(batcher) -> list:
    """Record every batch a `MicroBatcher` flushes: [(dense, cat, scores)]."""
    rec, inner = [], batcher._predict

    def predict(dense, cat):
        out = inner(dense, cat)
        rec.append((dense, cat, out))
        return out

    batcher._predict = predict
    return rec


def persistence_phase(ett, S, H, G, gen, batches):
    """Persistence on the stacked DLRM (26 x 250,000 x 128 f32, indexer
    AdaGrad, the 4 cycled B = 65,536 batches), in a temporary directory:
    (a) `train_dlrm` with a `DeltaCheckpointManager(base_every=4)` every 2
    steps for 8 steps (one base, three deltas), restored into a fresh model
    bitwise; (c) a refreshable service following that chain through
    `DeltaFollower`, swapped under 8 closed-loop clients (every flushed
    batch bitwise the old or the new tables' scores), then scoring bitwise
    the trained model's eval step; (b) `ckpt_manager` every 2 steps with a
    `DivergenceGuard` and a NaN-poisoned batch: one rollback, the model
    bitwise the checkpoint, the next delta save a base, finite losses
    after; the folded DeepFM's (6.5M, 129) stack through one base, one
    delta, a poll and a swap; (d) `trace_profile` around one step. Returns
    (launches, numbers)."""
    import shutil
    import tempfile
    from embeddingtables_tpu_torch import utils
    from embeddingtables_tpu_torch.utils.checkpoint import (load_leaf,
                                                            named_leaves)
    t0 = time.perf_counter()
    counter = LaunchCounter(S, H, G)
    cfg = ett.dlrm_small_config(vocab=PERSIST_VOCAB)
    opt = ett.SparseRowWiseAdaGrad(1e-3, method="indexer")
    tel = utils.Telemetry()
    saved_tel = utils.set_telemetry(tel)
    delta_ms = phase_spans(tel, "delta_ckpt")
    ckpt_ms = phase_spans(tel, "checkpoint")
    root = tempfile.mkdtemp(prefix="chip_smoke_persistence_")
    out = {}

    def fresh_dlrm(seed):
        return ett.init_dlrm(cfg, torch.Generator(device="cuda")
                             .manual_seed(seed), sparse_opt=opt)

    try:
        model = fresh_dlrm(SEED)
        mbytes = model_bytes(model)
        # At most two steps' ids a delta, each row its values, accumulator
        # and id; a base, two full checkpoints and a second base at once.
        delta_bound = 2 * 26 * B_TRAIN * (cfg.dim * 4 + 4 + 4)
        need = 4 * mbytes + 3 * delta_bound
        free = shutil.disk_usage(root).free
        require(free >= need, f"persistence needs {need / 1e9:.2f} GB free "
                f"under {root}, has {free / 1e9:.2f} GB")

        # (a) The delta chain, restored into a fresh model.
        chain = os.path.join(root, "chain")
        mgr = utils.DeltaCheckpointManager(chain, base_every=4)
        rec = recorded_saves(mgr)
        res, got = counter.run(lambda: ett.train_dlrm(
            cfg, itertools.cycle(batches), PERSIST_STEPS, sparse_opt=opt,
            model=model, delta_ckpt=mgr, delta_every=2, log_every=1,
            verbose=False))
        require([r["kind"] for r in rec.saves]
                == ["base", "delta", "delta", "delta"],
                f"delta chain saves {rec.saves}")
        require(got["scatter_add_rows_sorted"] == PERSIST_STEPS
                and got["gather_rows"] == 2 * PERSIST_STEPS + 3 * 2,
                f"delta chain launches {got}")
        require(all(math.isfinite(x) for x in res.losses),
                f"delta chain losses {res.losses}")
        for r, ms in zip(rec.saves, delta_ms):
            r["ms"] = ms
        fresh = fresh_dlrm(SEED + 1)
        with tel.phase("restore_delta", sync=True):
            ett.restore_delta(mgr, fresh)
        require(torch.equal(bits(fresh.tables.data),
                            bits(res.model.tables.data))
                and torch.equal(bits(fresh.emb_accum),
                                bits(res.model.emb_accum)),
                "restore_delta is not bitwise the live model")
        del fresh
        torch.cuda.empty_cache()
        restore_s = tel.phases["restore_delta"].total_s
        chain_bytes = dir_bytes(chain)
        base = rec.saves[0]
        out["delta_chain"] = {
            "saves": rec.saves, "base_save_gb_s": base["bytes"]
            / (base["ms"] / 1e3) / 1e9,
            "restore_ms": restore_s * 1e3, "restored_bytes": chain_bytes,
            "restore_gb_s": chain_bytes / restore_s / 1e9,
            "launches": got, "losses": res.losses}
        emit({"phase": "persistence_delta_chain", "table_bytes": mbytes,
              **out["delta_chain"]})

        # (c) A refreshable service following the chain, swapped under load.
        last = os.path.join(chain, f"delta_{PERSIST_STEPS}.npz")
        hidden = os.path.join(chain, "held_back.npz")
        os.replace(last, hidden)      # the follower first sees step 6
        follower = utils.DeltaFollower(chain, res.model.tables.data)
        with tel.phase("poll_base", sync=True):
            n0 = follower.poll()
        require(n0 == 3, f"the first poll applied {n0}, want base + 2")
        old = follower.data
        svc, _ = ett.make_refreshable_dlrm_service(res.model, max_batch=1024,
                                                   max_latency_ms=2.0)
        svc.swap_tables(old)
        seen = served_batches(svc)
        # The trainer's last delta lands; the follower applies it out of
        # place while the service keeps serving the tensor it holds.
        os.replace(hidden, last)
        with tel.phase("poll_delta", sync=True):
            applied = follower.poll()
        require(applied == 1, f"the second poll applied {applied}")
        # What applying a delta out of place costs on the card: one
        # table-sized copy beside the rows.
        last_delta = utils.deltackpt._load_npz(last)
        rows = last_delta["rows"].cuda().long()
        vals = last_delta["vals"].cuda()
        copy_ms = statistics.median(events_ms(
            lambda: follower.data.index_copy(0, rows, vals), reps=5))
        del last_delta, rows, vals
        swap, done = {}, threading.Event()

        def swap_when_busy():
            while len(seen) < 24 and not done.is_set():
                time.sleep(0.001)
            svc.swap_tables(follower.data)
            swap["at_batch"] = len(seen)

        swapper = threading.Thread(target=swap_when_busy)

        def drive():
            swapper.start()
            try:
                return closed_loop(
                    svc, lambda rng, b: make_request(rng, cfg, b),
                    per_client=64)
            finally:
                done.set()

        try:
            served, sgot = counter.run(drive)
            swapper.join()
            dense, cat = make_request(np.random.default_rng(SEED + 7), cfg,
                                      1024)
            after = svc.predict(dense, cat, timeout=300)
        finally:
            svc.stop()
        step = ett.make_eval_step(cfg)
        want = step(res.model, torch.from_numpy(dense).cuda(),
                    torch.from_numpy(cat).cuda()).cpu().numpy()
        require(np.array_equal(after.view(np.int32), want.view(np.int32)),
                "the refreshed service is not bitwise the trained model")
        require(torch.equal(bits(follower.data), bits(res.model.tables.data)),
                "the follower's tables are not the trained model's")
        kinds = []
        for d, c, scores in seen:
            args = (torch.from_numpy(d).cuda(), torch.from_numpy(c).cuda())
            new_s = step(res.model, *args).cpu().numpy()
            with swapped_tables(res.model, old):
                old_s = step(res.model, *args).cpu().numpy()
            is_new = np.array_equal(scores.view(np.int32),
                                    new_s.view(np.int32))
            is_old = np.array_equal(scores.view(np.int32),
                                    old_s.view(np.int32))
            require(is_new or is_old, "a served batch mixes old and new "
                    "tables (or matches neither)")
            kinds.append("new" if is_new and not is_old else
                         "old" if is_old and not is_new else "either")
        require(kinds.count("old") > 0 and kinds.count("new") > 0,
                f"the swap did not fall inside the run: {kinds}")
        out["service"] = {
            "requests": len(served), "batches": len(seen),
            "old_batches": kinds.count("old"),
            "new_batches": kinds.count("new"),
            "swap_at_batch": swap["at_batch"],
            "poll_base_ms": tel.phases["poll_base"].total_s * 1e3,
            "poll_delta_ms": tel.phases["poll_delta"].total_s * 1e3,
            "out_of_place_apply_ms": copy_ms,
            "launches": sgot, **latency_ms([x[2] for x in served])}
        emit({"phase": "persistence_refreshable_service", **out["service"]})
        del follower, old, seen, served
        shutil.rmtree(chain)
        torch.cuda.empty_cache()

        # (b) Full checkpoints, the divergence guard and a forced base.
        class CheckedGuard(utils.DivergenceGuard):
            """The guard, checking each rollback against the checkpoint
            files and timing it."""
            restore_ms = 0.0

            def observe(self, loss, m):
                r0 = time.perf_counter()
                m, rolled = super().observe(loss, m)
                if rolled:
                    torch.cuda.synchronize()
                    self.restore_ms = (time.perf_counter() - r0) * 1e3
                    path = os.path.join(self.ckpt.directory,
                                        str(self.ckpt.latest_step()))
                    for i, (name, t) in enumerate(named_leaves(m)):
                        if t.numel():
                            saved = load_leaf(path, i).to(t.device)
                            require(torch.equal(bits(t.detach()),
                                                bits(saved)),
                                    f"rollback: {name} is not the "
                                    "checkpoint's")
                return m, rolled

        ckpt = utils.CheckpointManager(os.path.join(root, "ckpt"),
                                       max_to_keep=1)
        chain_b = os.path.join(root, "chain_b")
        mgr_b = utils.DeltaCheckpointManager(chain_b, base_every=4)
        rec_b = recorded_saves(mgr_b)
        guard = CheckedGuard(ckpt)
        poisoned = dict(batches[0])
        poisoned["dense"] = torch.full_like(batches[0]["dense"], math.nan)
        stream = batches[:4] + [poisoned, batches[1]]
        model_b = fresh_dlrm(SEED)
        res_b, got_b = counter.run(lambda: ett.train_dlrm(
            cfg, iter(stream), len(stream), sparse_opt=opt, model=model_b,
            ckpt_manager=ckpt, ckpt_every=2, guard=guard, log_every=1,
            delta_ckpt=mgr_b, delta_every=2, verbose=False))
        losses = res_b.losses
        require(guard.rollbacks == 1, f"{guard.rollbacks} rollbacks")
        require(math.isnan(losses[4]) and all(
            math.isfinite(x) for i, x in enumerate(losses) if i != 4),
            f"guarded losses {losses}")
        require([r["kind"] for r in rec_b.saves] == ["base", "delta", "base"],
                f"after the rollback the next save is not a base: "
                f"{rec_b.saves}")
        fresh = fresh_dlrm(SEED + 1)
        ett.restore_delta(mgr_b, fresh)
        require(torch.equal(bits(fresh.tables.data),
                            bits(res_b.model.tables.data))
                and torch.equal(bits(fresh.emb_accum),
                                bits(res_b.model.emb_accum)),
                "the forced base is not the live model")
        del fresh
        torch.cuda.empty_cache()
        out["guard"] = {
            "losses": losses, "rollbacks": guard.rollbacks,
            "rollback_ms": guard.restore_ms, "saves": rec_b.saves,
            "checkpoint_ms": ckpt_ms, "checkpoint_bytes": mbytes,
            "checkpoint_gb_s": mbytes / (statistics.median(ckpt_ms) / 1e3)
            / 1e9, "rollback_gb_s": mbytes / (guard.restore_ms / 1e3) / 1e9,
            "launches": got_b}
        emit({"phase": "persistence_guard", **out["guard"]})

        # (d) A profiler trace around one step.
        trace_dir = os.path.join(root, "trace")
        train_step = ett.make_train_step(cfg, sparse_opt=opt)
        b = batches[2]

        def traced():
            with utils.trace_profile(trace_dir):
                train_step(model_b, b["dense"], b["cat"], b["label"])
                torch.cuda.synchronize()

        counter.run(traced)
        trace = os.path.join(trace_dir, "trace.json")
        require(os.path.isfile(trace) and os.path.getsize(trace) > 0
                and not tel.counters.get("trace_profile.unsupported"),
                "trace_profile wrote no trace")
        out["trace_bytes"] = os.path.getsize(trace)
        emit({"phase": "persistence_trace", "trace_bytes": out["trace_bytes"]})
        del res_b, model_b, res, model
        shutil.rmtree(chain_b)
        shutil.rmtree(os.path.join(root, "ckpt"))
        torch.cuda.empty_cache()

        # The folded DeepFM: one base, one delta (the off-grid gather), a
        # poll and a swap.
        dcfg = ett.deepfm_small_config(vocab=PERSIST_VOCAB)
        dmodel = ett.init_deepfm(dcfg, torch.Generator(device="cuda")
                                 .manual_seed(SEED), sparse_opt=opt)
        chain_d = os.path.join(root, "chain_deepfm")
        mgr_d = utils.DeltaCheckpointManager(chain_d, base_every=2)
        rec_d = recorded_saves(mgr_d)
        res_d, got_d = counter.run(lambda: ett.train_deepfm(
            dcfg, itertools.cycle(batches), 2, sparse_opt=opt, model=dmodel,
            delta_ckpt=mgr_d, delta_every=1, log_every=1, verbose=False))
        require([r["kind"] for r in rec_d.saves] == ["base", "delta"]
                and got_d["gather_rows"] == 2 * 2 + 2,
                f"DeepFM chain {rec_d.saves}, launches {got_d}")
        follower = utils.DeltaFollower(chain_d, dmodel.tables.data)
        require(follower.poll() == 2, "the DeepFM poll")
        svc, _ = ett.make_refreshable_service(res_d.model, max_batch=1024)
        try:
            svc.swap_tables(follower.data)
            dense, cat = make_request(np.random.default_rng(SEED + 8), dcfg,
                                      1024)
            (after,), sgot_d = counter.run(lambda: [
                svc.predict(dense, cat, timeout=300)])
        finally:
            svc.stop()
        want = ett.models.deepfm.make_eval_step(dcfg)(
            res_d.model, torch.from_numpy(dense).cuda(),
            torch.from_numpy(cat).cuda()).cpu().numpy()
        require(np.array_equal(after.view(np.int32), want.view(np.int32))
                and torch.equal(bits(follower.data),
                                bits(res_d.model.tables.data)),
                "the refreshed DeepFM service is not the trained model")
        out["deepfm"] = {"stack": list(dmodel.tables.data.shape),
                         "saves": rec_d.saves, "launches": got_d,
                         "service_launches": sgot_d}
        emit({"phase": "persistence_deepfm", **out["deepfm"]})
        del follower, res_d, dmodel
        torch.cuda.empty_cache()
    finally:
        utils.set_telemetry(saved_tel)
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "persistence_done", "seconds": time.perf_counter() - t0,
          "launches": counter.total})
    return counter.total, out


# ---------------------------------------------------------------------------
# Phase 14: microbatching and the towers' torch.optim state (dense_tx)
# ---------------------------------------------------------------------------

MICROBATCH_KS = (1, 2, 4, 8)
ADAM_STEPS = 8                      # a checkpoint at 4, resumed for 4 more


def adam_towers():
    """The towers' optimizer of the phase: `torch.optim.Adam` at 1e-3 (JAX's
    CLIs' `optax.adam(lr)`, whose defaults are torch's)."""
    return functools.partial(torch.optim.Adam, lr=1e-3)


def cuda_generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def same_state(a, b) -> bool:
    """Every tensor of two models' `state_dict()` bitwise equal."""
    sa, sb = a.state_dict(), b.state_dict()
    return list(sa) == list(sb) and all(
        torch.equal(bits(sa[k]) if sa[k].is_floating_point() else sa[k],
                    bits(sb[k]) if sb[k].is_floating_point() else sb[k])
        for k in sa)


def microbatch_case(counter, mod, model, opt, k, batches):
    """One `microbatch=k` recipe: the launches of one step, step times with
    a kernel profile, and the peak device memory of its steps."""
    step = mod.make_train_step(model.config, sparse_opt=opt, dense_lr=0.1,
                               microbatch=k)
    b0 = batches[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, got = counter.run(lambda: step(model, b0["dense"], b0["cat"],
                                      b0["label"]))
    t = step_times(ctr_runner(step, model, batches), B_TRAIN)
    return step, got, t, torch.cuda.max_memory_allocated() / 1e9


def microbatch_vs_monolithic(ett, opt, batch):
    """k = 4 against k = 1 on one batch, f32 towers, from one state: the
    table and its row state within 1e-5 of the largest change the k = 1
    step made to them plus two f32 roundings of their largest value (the
    CPU tests' re-association bound: a re-associated update may round the
    stored value one ulp the other way). The towers' gradients are sums
    over the 65,536 examples, which cancel, so their difference is only
    reported (largest difference over the largest update, per tensor).
    Returns (the largest share of the bound used, the towers' worst
    ratio)."""
    import copy
    cfg = dataclasses.replace(ett.dlrm_small_config(vocab=VOCAB),
                              compute_dtype=torch.float32)
    model = ett.init_dlrm(cfg, cuda_generator(SEED + 40), sparse_opt=opt)
    m4, m1 = copy.deepcopy(model), copy.deepcopy(model)
    args = (batch["dense"], batch["cat"], batch["label"])
    ett.make_train_step(cfg, sparse_opt=opt, dense_lr=0.1, microbatch=4)(
        m4, *args)
    ett.make_train_step(cfg, sparse_opt=opt, dense_lr=0.1)(m1, *args)
    worst, towers = 0.0, 0.0
    s0, s4, s1 = model.state_dict(), m4.state_dict(), m1.state_dict()
    for name, t0 in s0.items():
        if not t0.is_floating_point() or t0.numel() == 0:
            continue
        moved = float((s1[name] - t0).abs().max())
        diff = float((s4[name] - s1[name]).abs().max())
        if "_params." in name:
            towers = max(towers, diff / max(moved, 1e-30))
            continue
        bound = 1e-5 * moved + 2.0 ** -22 * float(s1[name].abs().max())
        require(diff <= bound, f"microbatch 4 vs 1: {name} differs by "
                f"{diff}, bound {bound}")
        worst = max(worst, diff / bound)
    del model, m4, m1
    torch.cuda.empty_cache()
    return worst, towers


def adam_towers_case(ett, S, G, counter, name, cfg, opt, batches, root):
    """Adam towers on one family: one step against the plain path, then
    `train_<name>(dense_tx=)` for ADAM_STEPS steps with a checkpoint every 4
    (a falling loss, one run-scatter a step); the step-4 checkpoint
    restored into a fresh model and trained 4 more steps equals the 8
    uninterrupted steps bitwise; one NaN batch under a `DivergenceGuard`
    rolls the towers and the Adam state back to the step-8 checkpoint
    bitwise."""
    from embeddingtables_tpu_torch import utils
    init, train = getattr(ett, f"init_{name}"), getattr(ett, f"train_{name}")
    mod = getattr(ett.models, name)
    adam = adam_towers()

    def fresh(seed):
        return init(cfg, cuda_generator(seed), sparse_opt=opt, dense_tx=adam)

    def run(model, batch_iter, steps, **kw):
        return train(cfg, batch_iter, steps, sparse_opt=opt, dense_lr=0.1,
                     dense_tx=adam, model=model, seed=SEED, log_every=1,
                     verbose=False, **kw)

    t0 = time.perf_counter()
    model = fresh(SEED)
    step = mod.make_train_step(cfg, sparse_opt=opt, dense_lr=0.1,
                               dense_tx=adam)
    b0 = batches[0]
    rtol = None if isinstance(opt, ett.SparseSGD) else 1e-6
    err = step_parity(S, G, step, model, (b0["dense"], b0["cat"],
                                          b0["label"]), rtol)
    mgr = utils.CheckpointManager(os.path.join(root, name))
    res, got = counter.run(lambda: run(model, itertools.cycle(batches),
                                       ADAM_STEPS, ckpt_manager=mgr,
                                       ckpt_every=4))
    losses = res.losses
    require(len(losses) == ADAM_STEPS
            and all(math.isfinite(x) for x in losses)
            and statistics.mean(losses[-4:]) < statistics.mean(losses[:4]),
            f"{name} Adam towers: losses did not fall {losses}")
    require(got["scatter_add_rows_sorted"] == ADAM_STEPS,
            f"{name} Adam towers: launches {got}")
    steps_held = {float(t) for k, t in model.dense_opt_state.state_dict()
                  .items() if k.endswith("__step")}
    require(steps_held == {float(ADAM_STEPS)},
            f"{name}: the Adam steps read {steps_held}")
    resumed = fresh(SEED + 1)
    mgr.restore(4, resumed)
    run(resumed, itertools.cycle(batches), 4)
    require(same_state(model, resumed),
            f"{name}: resumed at step 4 + 4 steps != 8 steps")
    del resumed
    guard = utils.DivergenceGuard(ckpt=mgr)
    nan = dict(b0, dense=torch.full_like(b0["dense"], float("nan")))
    run(model, iter([nan]), 1, guard=guard)
    want = fresh(SEED + 2)
    mgr.restore(ADAM_STEPS, want)
    require(guard.rollbacks == 1 and same_state(model, want),
            f"{name}: the rollback did not restore the towers and Adam state")
    del want
    t = step_times(ctr_runner(step, model, batches), B_TRAIN)
    emit({"phase": "dense_tx", "family": name, "optimizer": "torch.optim.Adam",
          "lr": 1e-3, "batch": B_TRAIN, "steps": ADAM_STEPS,
          "losses": losses, "launches": got,
          "parity": "bitwise" if rtol is None else f"rtol {rtol}",
          "parity_max_abs_err": err, "resume_bitwise": True,
          "rollback_bitwise": True,
          "tower_state_bytes": sum(v.numel() * v.element_size() for v in
                                   model.dense_opt_state.state_dict()
                                   .values()),
          "train_examples_per_s": res.examples_per_sec, **t,
          "seconds": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()


def microbatch_phase(ett, S, H, G, batches):
    """DLRM (26 x 250,000 x 128, B = 65,536) at microbatch k = 1, 2, 4, 8
    with SGD and indexer AdaGrad, DCN-v2 and the folded DeepFM at k = 4:
    per step k + 1 `gather_rows` launches (k lookups and the value permute)
    and one run-scatter, the step time and the peak memory; one k = 4 step
    per recipe against the plain path; k = 4 against k = 1; then Adam
    towers (`dense_tx`) on the three families (`adam_towers_case`).
    Returns the launches."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    counter = LaunchCounter(S, H, G)
    M = ett.models
    sgd = ett.SparseSGD(1e-4)
    adagrad = ett.SparseRowWiseAdaGrad(1e-3, method="indexer")
    cases = [("dlrm", M.dlrm, ett.dlrm_small_config(vocab=VOCAB), label, opt,
              MICROBATCH_KS)
             for label, opt in (("sgd", sgd), ("adagrad_indexer", adagrad))]
    cases += [("dcn", M.dcn, ett.dcn_small_config(vocab=VOCAB),
               "adagrad_indexer", adagrad, (4,)),
              ("deepfm", M.deepfm, ett.deepfm_small_config(vocab=VOCAB),
               "adagrad_indexer", adagrad, (4,))]
    for name, mod, cfg, label, opt, ks in cases:
        model = getattr(ett, f"init_{name}")(cfg, cuda_generator(SEED),
                                            sparse_opt=opt)
        for k in ks:
            step, got, t, peak = microbatch_case(counter, mod, model, opt, k,
                                                 batches)
            require(got == {"gather_rows": k + 1, "gather_bags": 0,
                            "scatter_add_rows_sorted": 1,
                            "hot_accumulate": 0},
                    f"{name} {label} k={k}: launches {got}")
            err = None
            if k == 4:
                b0 = batches[0]
                err = step_parity(S, G, step, model,
                                  (b0["dense"], b0["cat"], b0["label"]),
                                  None if opt is sgd else 1e-6)
            emit({"phase": "microbatch", "family": name, "recipe": label,
                  "k": k, "batch": B_TRAIN, "launches_per_step": got,
                  "parity": None if err is None else (
                      "bitwise" if opt is sgd else "rtol 1e-6"),
                  "parity_max_abs_err": err, **t, "peak_memory_gb": peak})
        del model
        torch.cuda.empty_cache()
    worst, towers = microbatch_vs_monolithic(ett, sgd, batches[0])
    emit({"phase": "microbatch_vs_monolithic", "k": 4, "towers": "float32",
          "tables_worst_share_of_bound": worst,
          "bound": "1e-5 x largest update + 2^-22 x largest value",
          "towers_worst_diff_over_update": towers})
    root = tempfile.mkdtemp(prefix="chip_smoke_dense_tx_")
    try:
        free = shutil.disk_usage(root).free
        require(free >= 10e9, f"dense_tx checkpoints need 10 GB free under "
                f"{root}, have {free / 1e9:.2f} GB")
        for name, cfg, opt in (
                ("dlrm", ett.dlrm_small_config(vocab=VOCAB), sgd),
                ("dcn", ett.dcn_small_config(vocab=VOCAB), adagrad),
                ("deepfm", ett.deepfm_small_config(vocab=VOCAB), adagrad)):
            adam_towers_case(ett, S, G, counter, name, cfg, opt, batches,
                             root)
            shutil.rmtree(os.path.join(root, name))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "microbatch_done", "launches": counter.total,
          "seconds": time.perf_counter() - t0})
    return counter.total


# ---------------------------------------------------------------------------
# Phase 15: the input pipeline
# ---------------------------------------------------------------------------

PIPELINE_ROWS = 8 * B_TRAIN         # a 524,288-row Criteo-format file


PREFETCH_STEPS = 40                 # the timed loops: 5 passes of the file


def loop_kernel_ms(run) -> float:
    """The device's kernel time of `run()` (a training loop), summed by the
    profiler; the profiler's own host cost stays out of the wall time,
    which an unprofiled run gives."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def input_pipeline_phase(ett, S, H, G):
    """A 524,288-row Criteo-format file written by the port's writer (26
    features hashed into the stacked DLRM's 250,000 rows): the native parser
    (required) bitwise `criteo_kaggle_batches` on the first batch, each
    parser's rows/s; the stacked DLRM trained from `CriteoFileLoader` ->
    `parallel_batches` -> `DevicePrefetcher` for 8 steps; the same host
    batches at `device_prefetch` 0 and 2 (losses and tables bitwise equal,
    examples/s and idle share of each); `NativeSyntheticCriteo` against the
    numpy generator at B = 65,536. Returns the launches."""
    import shutil
    import tempfile
    from embeddingtables_tpu_torch.io import criteo_file, loader, synth
    t0 = time.perf_counter()
    counter = LaunchCounter(S, H, G)
    require(loader.native_available(),
            f"the native Criteo parser did not build: {loader.native_error()}")
    require(synth.native_synth_available(),
            "the native synthesizer did not build")
    vocabs = (VOCAB,) * 26
    root = tempfile.mkdtemp(prefix="chip_smoke_input_")
    path = os.path.join(root, "train.txt")
    try:
        require(shutil.disk_usage(root).free >= 1e9,
                f"the Criteo file needs 1 GB free under {root}")
        w0 = time.perf_counter()
        size = criteo_file.write_criteo_file(path, PIPELINE_ROWS, VOCAB, SEED)
        write_s = time.perf_counter() - w0
        p0 = time.perf_counter()
        native = next(iter(loader.CriteoFileLoader(path, vocabs, B_TRAIN,
                                                   max_batches=1)))
        native_s = time.perf_counter() - p0
        p0 = time.perf_counter()
        oracle = next(ett.data.criteo_kaggle_batches(path, vocabs, B_TRAIN,
                                                     1))
        python_s = time.perf_counter() - p0
        require(all(native[k].dtype == oracle[k].dtype
                    and np.array_equal(native[k], oracle[k]) for k in oracle),
                "native parser != criteo_kaggle_batches on the first batch")
        p0 = time.perf_counter()
        host = list(loader.CriteoFileLoader(path, vocabs, B_TRAIN))
        file_s = time.perf_counter() - p0
        require(len(host) == 8, f"{len(host)} batches from the file")
        emit({"phase": "input_parse", "rows": PIPELINE_ROWS,
              "file_bytes": size, "write_s": write_s,
              "native_rows_per_s_first_batch": B_TRAIN / native_s,
              "python_rows_per_s_first_batch": B_TRAIN / python_s,
              "native_rows_per_s_whole_file": PIPELINE_ROWS / file_s,
              "first_batch_bitwise_oracle": True})

        cfg = ett.dlrm_small_config(vocab=VOCAB)
        opt = ett.SparseRowWiseAdaGrad(1e-3, method="indexer")

        def fresh():
            return ett.init_dlrm(cfg, cuda_generator(SEED), sparse_opt=opt)

        def shard(w):
            return loader.CriteoFileLoader(path, vocabs, B_TRAIN,
                                           skip_batches=4 * w, max_batches=4)

        model = fresh()
        res, got = counter.run(lambda: ett.train_dlrm(
            cfg, loader.parallel_batches(shard, workers=2, depth=2), 8,
            sparse_opt=opt, model=model, device_prefetch=2, log_every=1,
            verbose=False))
        require(len(res.losses) == 8
                and all(math.isfinite(x) for x in res.losses)
                and got["scatter_add_rows_sorted"] == 8
                and got["gather_rows"] == 16,
                f"file-fed loop: losses {res.losses}, launches {got}")
        emit({"phase": "input_file_loop", "steps": 8, "workers": 2,
              "device_prefetch": 2, "losses": res.losses, "launches": got,
              "examples_per_s": res.examples_per_sec})
        del model, res

        runs = {}
        for n in (0, 2):
            model = fresh()
            res, got = counter.run(lambda: ett.train_dlrm(
                cfg, iter(host), 8, sparse_opt=opt, model=model,
                device_prefetch=n, log_every=1, verbose=False))
            runs[n] = (res.losses, model, got)
        require(runs[0][0] == runs[2][0] and same_state(runs[0][1],
                                                        runs[2][1]),
                "device_prefetch=2 differs from device_prefetch=0")
        # The timed loops: PREFETCH_STEPS steps over the same host batches,
        # the loss read at the loop's default cadence, in the order 0, 2,
        # 2, 0; then each loop's kernel time under the profiler.
        rates = {0: [], 2: []}
        for n in (0, 2, 2, 0):
            rates[n].append(ett.train_dlrm(
                cfg, itertools.cycle(host), PREFETCH_STEPS, sparse_opt=opt,
                model=runs[n][1], device_prefetch=n,
                verbose=False).examples_per_sec)
        for n in (0, 2):
            model = runs[n][1]
            kernel_ms = loop_kernel_ms(lambda: ett.train_dlrm(
                cfg, itertools.cycle(host), PREFETCH_STEPS, sparse_opt=opt,
                model=model, device_prefetch=n, verbose=False))
            wall_ms = PREFETCH_STEPS * B_TRAIN / max(rates[n]) * 1e3
            emit({"phase": "input_prefetch", "device_prefetch": n,
                  "bitwise_steps": 8, "losses": runs[n][0],
                  "launches": runs[n][2], "bitwise_prefetch_0": True,
                  "timed_steps": PREFETCH_STEPS,
                  "examples_per_s": rates[n],
                  "kernel_ms_per_step": kernel_ms / PREFETCH_STEPS,
                  "wall_ms_per_step": wall_ms / PREFETCH_STEPS,
                  "device_idle_share": 1.0 - kernel_ms / wall_ms})
        del runs, model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not os.path.exists(path), "the Criteo file was not deleted")

    kw = dict(vocab_sizes=vocabs, batch_size=B_TRAIN, seed=SEED + 30)
    nat = synth.NativeSyntheticCriteo(**kw)
    py = ett.SyntheticCriteo(**kw)
    rates = {}
    for label, gen in (("native", nat.batches(4)), ("numpy", py.batches(4))):
        next(gen)
        s0 = time.perf_counter()
        for b in gen:
            require(b["cat"].shape == (26, B_TRAIN), "synthetic batch shape")
        rates[label] = 3 / (time.perf_counter() - s0)
    emit({"phase": "input_synth", "batch": B_TRAIN,
          "native_batches_per_s": rates["native"],
          "numpy_batches_per_s": rates["numpy"],
          "native_threads": nat.nthreads})
    emit({"phase": "input_done", "launches": counter.total,
          "seconds": time.perf_counter() - t0})
    return counter.total


# ---------------------------------------------------------------------------
# Phase 16: the binary RPC transport
# ---------------------------------------------------------------------------

RPC_CLIENTS = 8
RPC_PIPELINE = 64                   # requests in flight on each connection


def retrieval_ids_match(ids, ps, pi) -> int:
    """`ids` equal the plain path's `pi` except where two plain scores `ps`
    lie within 1e-5 of each other (a served batch's product may round
    differently); returns the near-tie positions."""
    gap = np.abs(np.diff(ps, axis=1)) <= 1e-5 * np.abs(ps[:, 1:])
    tied = np.zeros_like(pi, dtype=bool)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    require(bool(((ids == pi) | tied).all()),
            "retrieval ids differ from the plain path's")
    return int(tied.sum())


def pipelined_clients(submit_for, make_reqs, swap=None, waves: int = 1):
    """RPC_CLIENTS threads, each submitting its RPC_PIPELINE requests
    through `submit_for(k)` (one connection or the batchers) in `waves`
    rounds, all of a round at once, and waiting for the round's results
    before the next: [(model, request, result, latency_s)]. `swap()` runs
    once a quarter of the responses are in."""
    done = threading.Semaphore(0)
    total = RPC_CLIENTS * RPC_PIPELINE

    def client(k):
        submit = submit_for(k)
        reqs = make_reqs(k)
        per = -(-len(reqs) // waves)
        out = []
        for w in range(waves):
            futs = []
            for name, req in reqs[w * per:(w + 1) * per]:
                t = time.perf_counter()
                fut = submit(name, *req)
                stamp = {}
                fut.add_done_callback(lambda f, s=stamp: (
                    s.setdefault("t", time.perf_counter()), done.release()))
                futs.append((name, req, fut, t, stamp))
            for name, req, fut, t, stamp in futs:
                res = fut.result(timeout=300)
                # A waiter may wake before the callbacks run.
                out.append((name, req, res,
                            stamp.get("t", time.perf_counter()) - t))
        return out

    with ThreadPoolExecutor(max_workers=RPC_CLIENTS) as pool:
        futs = [pool.submit(client, k) for k in range(RPC_CLIENTS)]
        if swap is not None:
            for _ in range(total // 4):
                require(done.acquire(timeout=300), "responses stalled")
            swap()
        return [r for f in futs for r in f.result(timeout=600)]


def rpc_phase(ett, S, H, G):
    """`serve_rpc` over a `ModelRouter` holding "dlrm" (the 26 x 250,000 x
    128 DLRM, f32 tables and towers), "dlrm_int8" (its int8 rows) and
    "retrieval" (the two-tower over 2M items); 8 clients, each pipelining
    64 requests of 1-256 examples over one connection. The same clients on
    the in-process batchers, then over RPC (p50 / p95 of both, and
    `gather_rows` launches = served f32 and retrieval batches), then over
    RPC again in four rounds of 16 requests a client, "dlrm" swapped once a
    quarter of the responses are in. Every response is held to the
    direct eval of its request (rtol 1e-5; the swapped run: the old or the
    new model's), the int8 scores to the quantized eval, retrieval scores to
    the plain path (rtol 1e-5) and its ids to the plain path's. Returns the
    launches."""
    from embeddingtables_tpu_torch import quant, rpc
    t0 = time.perf_counter()
    counter = LaunchCounter(S, H, G)
    tt = ett.models.two_tower
    cfg = dataclasses.replace(ett.dlrm_small_config(vocab=VOCAB),
                              compute_dtype=torch.float32)
    model = ett.init_dlrm(cfg, cuda_generator(SEED))
    swapped = ett.init_dlrm(cfg, cuda_generator(SEED + 50))
    tcfg = ett.TwoTowerConfig(query_vocab_sizes=TT_QUERY_VOCABS,
                              item_vocab=TT_ITEMS, num_dense=4, dim=64,
                              embed_dim=64, query_mlp=(256, 64),
                              item_mlp=(256, 64))
    tmodel = ett.init_two_tower(tcfg, cuda_generator(SEED + 51))
    serve = dict(max_batch=2048, max_latency_ms=2.0)
    router = rpc.ModelRouter()
    router.register("dlrm", ett.make_dlrm_service(model, **serve))
    router.register("dlrm_int8", ett.make_dlrm_service(model, quantized=True,
                                                       **serve))
    router.register("retrieval", ett.make_retrieval_service(
        tmodel, k=10, max_batch=256, max_latency_ms=2.0))
    _, int8_eval = quant.quantize_dlrm(model, bits=8)
    eval_step = ett.make_eval_step(cfg)
    run10 = tt.make_retriever(tmodel, k=10)
    with plain_gathers(G):
        index_p = tt.build_item_index(tmodel)
    names = ("dlrm", "dlrm_int8", "retrieval")

    def make_reqs(k):
        rng = np.random.default_rng(SEED + 4000 + k)
        out = []
        for i in range(RPC_PIPELINE):
            name, b = names[(k + i) % 3], int(rng.integers(1, 257))
            if name == "retrieval":
                req = (rng.standard_normal((b, 4)).astype(np.float32),
                       np.stack([rng.integers(0, v, b) for v in
                                 TT_QUERY_VOCABS]).astype(np.int32))
            else:
                req = make_request(rng, cfg, b)
            out.append((name, req))
        return out

    def batches_served():
        return {n: router.get(n).stats_snapshot()["batches"] for n in names}

    def check(served, swap_models=None):
        """Hold every response to its reference; returns the largest
        errors, the near ties and how many answered from each model."""
        errs = dict.fromkeys(names, 0.0)
        ties, source = 0, {"old": 0, "new": 0}
        for name, (dense, cat), res, _ in served:
            if name == "retrieval":
                scores, ids = res
                with plain_gathers(G):
                    ps, pi = run10(index_p, dense, cat)
                ps, pi = ps.cpu().numpy(), pi.cpu().numpy()
                np.testing.assert_allclose(scores, ps, rtol=1e-5, atol=1e-6)
                ties += retrieval_ids_match(ids, ps, pi)
                errs[name] = max(errs[name], float(np.abs(scores - ps).max()))
                continue
            if name == "dlrm_int8":
                want = int8_eval(dense, cat).cpu().numpy()
            elif swap_models is None:
                want = eval_step(model, dense, cat).cpu().numpy()
            else:
                old, new = (eval_step(m, dense, cat).cpu().numpy()
                            for m in swap_models)
                is_old = np.allclose(res, old, rtol=1e-5, atol=1e-6)
                is_new = np.allclose(res, new, rtol=1e-5, atol=1e-6)
                require(is_old != is_new,
                        "a swapped response is neither (or both) models'")
                source["old" if is_old else "new"] += 1
                want = old if is_old else new
            np.testing.assert_allclose(res, want, rtol=1e-5, atol=1e-6)
            errs[name] = max(errs[name], float(np.abs(res - want).max()))
        return errs, ties, source

    server = rpc.serve_rpc(router)
    clients = []
    try:
        warm = rpc.RPCClient(*server.address, timeout=300)
        for name, req in make_reqs(99)[:6]:
            warm.predict(name, *req, timeout=300)
        warm.close()
        inproc = pipelined_clients(
            lambda k: lambda name, d, c: router.get(name).submit(d, c),
            make_reqs)
        clients = [rpc.RPCClient(*server.address, timeout=300)
                   for _ in range(RPC_CLIENTS)]
        before = batches_served()
        served, got = counter.run(lambda: pipelined_clients(
            lambda k: clients[k].submit, make_reqs))
        after = batches_served()
        batches = {n: after[n] - before[n] for n in names}
        require(len(served) == RPC_CLIENTS * RPC_PIPELINE,
                f"{len(served)} RPC responses")
        require(got["gather_rows"] == batches["dlrm"] + batches["retrieval"]
                and got["scatter_add_rows_sorted"] == 0,
                f"RPC launches {got}, batches {batches}")
        errs, ties, _ = check(served)
        lat = {label: dict(latency_ms([x[3] for x in runs]), by_model={
            n: latency_ms([x[3] for x in runs if x[0] == n]) for n in names})
            for label, runs in (("in_process", inproc), ("rpc", served))}
        emit({"phase": "rpc_serve", "clients": RPC_CLIENTS,
              "pipelined_per_client": RPC_PIPELINE,
              "requests": len(served),
              "examples": sum(x[1][0].shape[0] for x in served),
              "batches": batches, "launches": got, "max_abs_err": errs,
              "retrieval_near_ties": ties,
              "in_process": lat["in_process"], "rpc": lat["rpc"],
              "rpc_over_in_process_p50_ms": lat["rpc"]["latency_ms_p50"]
              - lat["in_process"]["latency_ms_p50"],
              "rpc_over_in_process_p95_ms": lat["rpc"]["latency_ms_p95"]
              - lat["in_process"]["latency_ms_p95"]})

        old = router.get("dlrm")

        def swap():
            # The old batcher stops after the new one takes the name, once
            # requests routed to it a moment before have reached its queue.
            router.register("dlrm", ett.make_dlrm_service(swapped, **serve),
                            stop_previous=False)
            time.sleep(0.05)
            old.stop()

        served, got_swap = counter.run(lambda: pipelined_clients(
            lambda k: clients[k].submit, make_reqs, swap=swap, waves=4))
        require(len(served) == RPC_CLIENTS * RPC_PIPELINE,
                "a request was lost across the swap")
        errs, ties2, source = check(served, (model, swapped))
        require(source["old"] > 0 and source["new"] > 0,
                f"the swap split the responses {source}")
        emit({"phase": "rpc_hot_swap", "requests": len(served),
              "dlrm_from": source, "launches": got_swap, "max_abs_err": errs,
              "retrieval_near_ties": ties2, "lost": 0,
              **latency_ms([x[3] for x in served])})
    finally:
        for c in clients:
            c.close()
        server.stop()
        router.stop_all()
    del model, swapped, tmodel, index_p
    torch.cuda.empty_cache()
    emit({"phase": "rpc_done", "launches": counter.total,
          "seconds": time.perf_counter() - t0})
    return counter.total


# ---------------------------------------------------------------------------
# Phase 16: the sharded DLRM over every card (one rank per card, NCCL)
# ---------------------------------------------------------------------------

MESH_STEPS = 6                      # timed steps per recipe, after a warm-up
MESH_BATCHES = 4                    # cycled SyntheticCriteo batches
MESH_CAPACITY = 2.0                 # the butterfly's capacity factor


def mesh_recipes(ett):
    """(name, optimizer) of the mesh phase; each runs on both exchanges."""
    return (("sgd", ett.SparseSGD(1e-4)),
            ("adagrad_indexer", ett.SparseRowWiseAdaGrad(1e-3,
                                                         method="indexer")),
            ("lazy_adam", ett.SparseLazyAdam(1e-3)),
            ("ftrl_l1", ett.SparseFTRL(0.05, l1=1e-3)))


class CollectiveTimer:
    """CUDA events around every collective of a placement (an
    `Exchange`'s `timer`), summed by name."""

    def __init__(self):
        self.events = []

    @contextlib.contextmanager
    def __call__(self, name):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.events.append((name, start, end))

    def totals(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for name, s, e in self.events:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


def exchange_bytes(ex, exchange: str, b_local: int, t: int, d: int,
                   tower_params: int) -> dict:
    """The bytes one rank hands the collectives in one step, from the
    shapes (f32 rows and deltas, int32 ids), and the bytes a ring moves
    over its links for them ((n-1)/n of an all-gather's output or a
    reduce-scatter's input, 2(n-1)/n of an all-reduce, (n-1)/n of an
    all-to-all's input)."""
    from embeddingtables_tpu_torch.parallel.alltoall import capacity
    n, b = ex.n, b_local * ex.n_data
    share = (n - 1) / n
    towers = 4 * (tower_params + 1)
    if exchange == "gather":
        parts = {"ids_all_gather": (4 * b_local * t, 4 * b * t * share),
                 "rows_reduce_scatter": (4 * b * t * d, 4 * b * t * d * share),
                 "update_all_gather": (4 * b_local * t * (d + 1),
                                       4 * b * t * (d + 1) * share)}
    else:
        cap = capacity(b_local * t // ex.n_model, n, MESH_CAPACITY)
        slots, rows = 4 * n * cap, 4 * n * cap * d
        parts = {"lookup_all_to_all": (slots + rows, (slots + rows) * share),
                 "update_all_to_all": (slots + rows, (slots + rows) * share),
                 "overflow_all_reduce": (16, 32 * share)}
    parts["towers_all_reduce"] = (towers, 2 * towers * share)
    return {"input_bytes": sum(v[0] for v in parts.values()),
            "ring_bytes": sum(v[1] for v in parts.values()),
            "by_collective": {k: v[0] for k, v in parts.items()}}


def same_delta_update(ett, P, mesh, n, cfg32, opt, exchange, fresh,
                      batch):
    """The sharded update of one step's delta against the single-device
    update of the same delta, on every rank: the single-device model's
    forward and backward on the global `batch` give the `(T, B, D)` delta;
    each rank feeds its block to the exchange's update (`owned_apply`, or
    `sharded_update_a2a` at a capacity of n), the single-device model
    applies the whole. Returns the largest difference of the table and the
    row state, unsharded, against the single-device ones."""
    from embeddingtables_tpu_torch.models.dlrm import (
        bce_loss, embedding_forward, forward_from_embeddings,
        lazy_stack_update, stacked_flat_indices)
    from embeddingtables_tpu_torch.parallel.alltoall import \
        sharded_update_a2a
    from embeddingtables_tpu_torch.parallel.sharded import owned_apply
    single = fresh()
    flat, valid = stacked_flat_indices(single.tables, batch["cat"])
    emb = embedding_forward(single.tables, batch["cat"]).requires_grad_(True)
    loss = bce_loss(forward_from_embeddings(single.bottom, single.top, cfg32,
                                            batch["dense"], emb),
                    batch["label"])
    (delta,) = torch.autograd.grad(loss, [emb])
    delta = delta.float()
    sm = P.shard_dlrm(fresh(), mesh, "data", sparse_opt=opt)
    ex = sm.tables.exchange
    t, b = batch["cat"].shape
    size = b // ex.n_data
    sl = slice(ex.data_index * size, (ex.data_index + 1) * size)
    idx = flat.view(t, b)[:, sl].t().contiguous()
    rows = delta[:, sl].transpose(0, 1).contiguous()
    if exchange == "gather":
        sm.emb_state = owned_apply(sm.tables, idx, rows, None, opt,
                                   sm.emb_state)
    else:
        sm.emb_state, _ = sharded_update_a2a(
            mesh, sm.tables, sm.emb_state, ett.SparseEmbeddingUpdate(
                delta=rows.reshape(-1, cfg32.dim), indices=idx.reshape(-1)),
            opt, capacity_factor=float(n))
    _, state = opt.apply(single.tables.data, lazy_stack_update(
        flat, valid, delta, cfg32.dim, cfg32.combiner), single.emb_state)
    un = P.unshard_dlrm(sm)
    torch.cuda.synchronize()
    pairs = [(un.tables.data, single.tables.data)] + [
        (a, b) for a, b in zip(un.emb_state, state) if a.is_floating_point()]
    for a, b in pairs:
        require(torch.allclose(a, b, rtol=1e-6, atol=1e-7),
                f"mesh same-delta update {exchange} {type(opt).__name__}: "
                f"off by {max_abs_err(a, b)}")
    return max(max_abs_err(a, b) for a, b in pairs)


def mesh_parity(ett, P, mesh, rank, n, cfg32, blocks, global_batches):
    """Two sharded steps against two single-device steps from the same
    weights, each exchange and optimizer. One rank: SGD and indexer AdaGrad
    bitwise (tables, row state, towers, losses), lazy Adam and FTRL to rtol
    1e-6 under deterministic algorithms. More ranks: rank 0 replays the
    global batches unsharded on its card; losses to rtol 1e-5; tables of
    SGD and AdaGrad to rtol 1e-5 with an atol of 1e-6. Lazy Adam's first
    steps move each touched entry by about lr whatever the size of its
    gradient, so a gradient near zero whose sign the ranks' other order of
    additions flips moves it the other way (9e-4 at lr 1e-3 on four cards),
    and FTRL's l1 threshold can flip an entry to zero the same way: for
    them the tables are held instead through `same_delta_update`, the
    sharded update of one delta against the single-device update of it
    (rtol 1e-6 under deterministic algorithms). The butterfly runs at a
    capacity factor of n, which drops nothing."""
    out = []
    for exchange in ("gather", "a2a"):
        for name, opt in mesh_recipes(ett):
            dense = name in ("lazy_adam", "ftrl_l1")
            torch.use_deterministic_algorithms(dense, warn_only=True)
            try:
                def fresh(opt=opt):
                    return ett.init_dlrm(cfg32, torch.Generator(
                        device="cuda").manual_seed(SEED), device="cuda",
                        sparse_opt=opt)
                sm = P.shard_dlrm(fresh(), mesh, "data", sparse_opt=opt)
                step = P.make_sharded_train_step(
                    cfg32, mesh, "data", sparse_opt=opt, dense_lr=0.1,
                    exchange=exchange, capacity_factor=float(n))
                losses = [float(step(sm, *b)) for b in blocks[:2]]
                un = P.unshard_dlrm(sm)
                del sm
                row = {"exchange": exchange, "recipe": name}
                if rank == 0:
                    single = fresh()
                    step1 = ett.make_train_step(cfg32, sparse_opt=opt,
                                                dense_lr=0.1)
                    want = [float(step1(single, b["dense"], b["cat"],
                                        b["label"]))
                            for b in global_batches[:2]]
                    torch.cuda.synchronize()
                    err = max_abs_err(un.tables.data, single.tables.data)
                    if n == 1 and not dense:
                        tolerance = "bitwise"
                        require(losses == want, f"mesh parity {exchange} "
                                f"{name}: losses {losses} != {want}")
                        pairs = ([(un.tables.data, single.tables.data)]
                                 + list(zip(un.emb_state, single.emb_state))
                                 + list(zip(un.parameters(),
                                            single.parameters())))
                        for a, b in pairs:
                            require(torch.equal(a, b), f"mesh parity "
                                    f"{exchange} {name}: not bitwise")
                    else:
                        rtol, atol = (1e-6, 1e-7) if n == 1 else (1e-5, 1e-6)
                        np.testing.assert_allclose(losses, want, rtol=rtol)
                        tolerance = f"losses rtol {rtol}"
                        if n == 1 or not dense:
                            tolerance += f", tables rtol {rtol} atol {atol}"
                            require(torch.allclose(un.tables.data,
                                                   single.tables.data,
                                                   rtol=rtol, atol=atol),
                                    f"mesh parity {exchange} {name}: tables "
                                    f"off by {err} (rtol {rtol}, atol "
                                    f"{atol})")
                    row.update(tolerance=tolerance, max_abs_err=err,
                               losses=losses)
                    del single
                del un
                torch.cuda.empty_cache()
                if n > 1 and dense:
                    row["same_delta_max_abs_err"] = same_delta_update(
                        ett, P, mesh, n, cfg32, opt, exchange, fresh,
                        global_batches[0])
                    row["same_delta_tolerance"] = "rtol 1e-6"
                    torch.cuda.empty_cache()
                out.append(row)
            finally:
                torch.use_deterministic_algorithms(False)
    return out


def mesh_service(ett, P, mesh, rank, cfg32, blocks):
    """The sharded model behind `make_dlrm_service(mesh=...)`: rank 0 sends
    64 requests of 1-256 examples from 4 closed-loop clients, each held to
    the unsharded model's eval on rank 0 (rtol 1e-5); the other ranks
    follow until rank 0 stops. Returns (rank 0's summary, gather_rows
    launches)."""
    from embeddingtables_tpu_torch.ops.cuda import gather as G
    opt = ett.SparseSGD(1e-4)
    sm = P.shard_dlrm(ett.init_dlrm(cfg32, torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda"), mesh, "data")
    P.make_sharded_train_step(cfg32, mesh, "data", sparse_opt=opt,
                              dense_lr=0.1)(sm, *blocks[0])
    ref = P.unshard_dlrm(sm)
    torch.cuda.synchronize()
    G.gather_rows.launches = 0
    svc = ett.make_dlrm_service(sm, mesh=mesh, max_batch=1024,
                                max_latency_ms=2.0)
    if rank != 0:
        torch.cuda.synchronize()
        return {"followed_batches": svc.batches}, G.gather_rows.launches
    t0 = time.perf_counter()
    try:
        served = closed_loop(svc, lambda rng, b: make_request(rng, cfg32, b),
                             clients=4, per_client=16)
    finally:
        svc.stop()
    torch.cuda.synchronize()
    launches = G.gather_rows.launches
    seconds = time.perf_counter() - t0
    step = ett.make_eval_step(cfg32)
    err = 0.0
    for (dense, cat), got, _ in served:
        want = step(ref, dense, cat).cpu().numpy()
        require(np.all(np.isfinite(got)), "mesh service: non-finite scores")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        err = max(err, float(np.abs(got - want).max()))
    stats = svc.stats_snapshot()
    return ({"requests": len(served), "batches": stats["batches"],
             "examples": stats["examples"], "seconds": seconds,
             "max_abs_err_vs_unsharded": err, "gather_rows_launches": launches,
             **latency_ms([lat for _, _, lat in served])}, launches)


MESH_FAMILY_STEPS = 4               # timed steps per family recipe


def mesh_family_cfgs(ett):
    """(label, family, cfg) of the CTR families on the mesh, at the DLRM's
    widths (26 x 250,000 x 128): DCN-v2, DeepFM folded and unfolded."""
    fm = ett.deepfm_small_config(vocab=VOCAB)
    return (("dcn", "dcn", ett.dcn_small_config(vocab=VOCAB)),
            ("deepfm_folded", "deepfm", fm),
            ("deepfm_unfolded", "deepfm",
             dataclasses.replace(fm, fold_fm_w=False)))


def mesh_family_opts(ett):
    return (("sgd", ett.SparseSGD(1e-4)),
            ("adagrad_indexer", ett.SparseRowWiseAdaGrad(1e-3,
                                                         method="indexer")))


def two_tower_config(ett):
    """The repo's two-tower shape: dim 64, MLPs 256-64, 4 dense features,
    1M / 100k / 1k query rows and 2M items."""
    return ett.TwoTowerConfig(query_vocab_sizes=TT_QUERY_VOCABS,
                              item_vocab=TT_ITEMS, num_dense=4, dim=64,
                              embed_dim=64, query_mlp=(256, 64),
                              item_mlp=(256, 64))


def sharded_api(P, family):
    """(shard, sharded train step, sharded eval step, unshard) of a
    family."""
    return {"dlrm": (P.shard_dlrm, P.make_sharded_train_step,
                     P.make_sharded_eval_step, P.unshard_dlrm),
            "dcn": (P.shard_dcn, P.make_sharded_dcn_train_step,
                    P.make_sharded_dcn_eval_step, P.unshard_dcn),
            "deepfm": (P.shard_deepfm, P.make_sharded_deepfm_train_step,
                       P.make_sharded_deepfm_eval_step, P.unshard_deepfm),
            "two_tower": (P.shard_two_tower, P.make_sharded_tt_train_step,
                          None, P.unshard_two_tower)}[family]


def family_launches(family, cfg) -> dict:
    """A sharded gather step's launches on each rank: one `gather_rows` a
    stack for the lookup and one for the update's value permute, one
    run-scatter a stack (SGD and indexer AdaGrad)."""
    stacks = 2 if family == "two_tower" or (
        family == "deepfm" and not cfg.folded) else 1
    return {"gather_rows": 2 * stacks, "scatter_add_rows_sorted": stacks}


def timed_sharded_steps(S, G, step, model, blocks, steps: int,
                        exchanges=None) -> dict:
    """A warm-up step, then `steps` steps timed with CUDA events and their
    launches counted, then one more step with its collectives timed (those
    of the model's tables' exchange, or of every exchange of `exchanges`);
    the peak memory since the caller's reset."""
    outs = [step(model, *blocks[0])]
    torch.cuda.synchronize()
    G.gather_rows.launches = 0
    zero_scatter(S)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(steps):
        outs.append(step(model, *blocks[(i + 1) % len(blocks)]))
    end.record()
    torch.cuda.synchronize()
    launches = {"gather_rows": G.gather_rows.launches,
                "scatter_add_rows_sorted": scatter_count(S)}
    if exchanges is None:
        tables = getattr(model, "tables", None) or model.query_tables
        exchanges = [tables.exchange]
    timer = CollectiveTimer()
    for ex in exchanges:
        ex.timer = timer
    step(model, *blocks[0])
    collectives = timer.totals()
    for ex in exchanges:
        ex.timer = None
    return {"losses": [float(o[0] if isinstance(o, tuple) else o)
                       for o in outs],
            "step_ms": start.elapsed_time(end) / steps,
            "launches": launches, "collective_ms": collectives,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def mesh_families(ett, P, S, G, mesh, rank, blocks, tt_blocks, results):
    """DCN, DeepFM folded and unfolded (B = 65,536 global) and the two-tower
    model (B = 16,384 global) on the mesh, SGD and indexer AdaGrad on the
    gather exchange: each recipe's step ms, collective ms, peak memory and
    launches a rank, put on `results`."""
    tt_cfg = two_tower_config(ett)
    recipes = [(label, family, cfg) for label, family, cfg
               in mesh_family_cfgs(ett)] + [("two_tower", "two_tower",
                                             tt_cfg)]
    for label, family, cfg in recipes:
        for name, opt in mesh_family_opts(ett):
            r0 = time.perf_counter()
            shard, make_step, _, _ = sharded_api(P, family)
            single = getattr(ett, f"init_{family}")(
                cfg, torch.Generator(device="cuda").manual_seed(SEED),
                device="cuda", sparse_opt=opt)
            model = shard(single, mesh, "data", sparse_opt=opt)
            del single
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step = make_step(cfg, mesh, "data", sparse_opt=opt, dense_lr=0.1)
            got = timed_sharded_steps(
                S, G, step, model, tt_blocks if family == "two_tower"
                else blocks, MESH_FAMILY_STEPS)
            results.put({"kind": "family", "rank": rank, "family": label,
                         "recipe": name, **got,
                         "per_step": family_launches(family, cfg),
                         "shard_rows": (model.tables.rows_local
                                        if family != "two_tower" else
                                        model.item_table.rows_local),
                         "seconds": time.perf_counter() - r0})
            del model, step
            torch.cuda.empty_cache()


def mesh_family_parity(ett, P, mesh, rank, n, blocks, global_batches,
                       tt_blocks, tt_global):
    """Two sharded steps of every family against two single-device steps
    from the same weights (f32 towers), SGD and indexer AdaGrad. One rank:
    bitwise (losses, tables, row states, towers). More ranks: rank 0
    replays the global batches unsharded; CTR losses rtol 1e-5 and tables
    rtol 1e-5 / atol 1e-6; the two-tower model at JAX's sharded-test
    tolerances (losses rtol 1e-4, tables and towers rtol 5e-4 / atol
    1e-5)."""
    out = []
    recipes = [(label, family, dataclasses.replace(
        cfg, compute_dtype=torch.float32))
        for label, family, cfg in mesh_family_cfgs(ett)]
    recipes.append(("two_tower", "two_tower", two_tower_config(ett)))
    for label, family, cfg in recipes:
        tt = family == "two_tower"
        for name, opt in mesh_family_opts(ett):
            def fresh(cfg=cfg, family=family, opt=opt):
                return getattr(ett, f"init_{family}")(
                    cfg, torch.Generator(device="cuda").manual_seed(SEED),
                    device="cuda", sparse_opt=opt)
            shard, make_step, _, unshard = sharded_api(P, family)
            sm = shard(fresh(), mesh, "data", sparse_opt=opt)
            step = make_step(cfg, mesh, "data", sparse_opt=opt, dense_lr=0.1)
            outs = [step(sm, *b) for b in (tt_blocks if tt else blocks)[:2]]
            losses = [float(o[0] if tt else o) for o in outs]
            un = unshard(sm)
            del sm
            torch.cuda.empty_cache()
            row = {"family": label, "recipe": name}
            if rank == 0:
                single = fresh()
                step1 = (ett.models.two_tower.make_train_step(
                    cfg, sparse_opt=opt, dense_lr=0.1) if tt else
                    getattr(ett.models, {"dcn": "make_dcn_train_step",
                                         "deepfm": "make_deepfm_train_step"}
                            [family])(cfg, sparse_opt=opt, dense_lr=0.1))
                keys = ("dense", "q_cat", "item_ids") if tt else (
                    "dense", "cat", "label")
                want = []
                for b in (tt_global if tt else global_batches)[:2]:
                    o = step1(single, *(b[k] for k in keys))
                    want.append(float(o[0] if tt else o))
                torch.cuda.synchronize()
                pairs = [(a.detach(), b.detach()) for a, b in (
                    list(zip(un.buffers(), single.buffers()))
                    + list(zip(un.parameters(), single.parameters())))]
                err = max(max_abs_err(a, b) for a, b in pairs
                          if a.is_floating_point() and a.numel())
                if n == 1:
                    tolerance = "bitwise"
                    require(losses == want, f"mesh family parity {label} "
                            f"{name}: losses {losses} != {want}")
                    for a, b in pairs:
                        require(torch.equal(a, b), f"mesh family parity "
                                f"{label} {name}: not bitwise")
                else:
                    lt, rtol, atol = ((1e-4, 5e-4, 1e-5) if tt
                                      else (1e-5, 1e-5, 1e-6))
                    np.testing.assert_allclose(losses, want, rtol=lt)
                    for a, b in pairs:
                        if a.is_floating_point() and a.numel():
                            require(torch.allclose(a, b, rtol=rtol,
                                                   atol=atol),
                                    f"mesh family parity {label} {name}: "
                                    f"off by {max_abs_err(a, b)}")
                    tolerance = (f"losses rtol {lt}, tables and towers rtol "
                                 f"{rtol} atol {atol}")
                row.update(tolerance=tolerance, max_abs_err=err,
                           losses=losses)
                del single
            del un
            torch.cuda.empty_cache()
            out.append(row)
    return out


def mesh_family_services(ett, P, G, mesh, rank, blocks):
    """DCN and the folded DeepFM behind their mesh services (f32 towers, 4
    closed-loop clients x 8 requests of 1-256 examples, every score the
    unsharded eval's to rtol 1e-5) and the sharded retrieval service over
    2M items (4 clients x 8 requests of 1-256 queries, ids the plain
    single-device retriever's under `retrieval_ids_match`, scores rtol
    1e-5). Rank 0 returns each service's summary, the others what they
    followed; with the `gather_rows` launches of each."""
    out = []
    for label, family, cfg in mesh_family_cfgs(ett)[:2]:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        shard, _, _, unshard = sharded_api(P, family)
        sm = shard(getattr(ett, f"init_{family}")(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda"), mesh, "data")
        ref = unshard(sm)
        torch.cuda.synchronize()
        G.gather_rows.launches = 0
        svc = getattr(ett, f"make_{family}_service")(
            sm, mesh=mesh, max_batch=1024, max_latency_ms=2.0)
        if rank != 0:
            torch.cuda.synchronize()
            out.append({"service": label, "followed_batches": svc.batches,
                        "launches": G.gather_rows.launches})
            del sm, ref
            continue
        t0 = time.perf_counter()
        try:
            served = closed_loop(svc, lambda rng, b: make_request(rng, cfg,
                                                                  b),
                                 clients=4, per_client=8)
        finally:
            svc.stop()
        torch.cuda.synchronize()
        launches, seconds = G.gather_rows.launches, time.perf_counter() - t0
        ev = getattr(ett.models, {"dcn": "make_dcn_eval_step",
                                  "deepfm": "make_deepfm_eval_step"}[family])(
            cfg)
        err = 0.0
        for (dense, cat), got, _ in served:
            want = ev(ref, dense, cat).cpu().numpy()
            require(np.all(np.isfinite(got)), f"mesh {label} service: "
                    "non-finite scores")
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            err = max(err, float(np.abs(got - want).max()))
        stats = svc.stats_snapshot()
        out.append({"service": label, "requests": len(served),
                    "batches": stats["batches"], "seconds": seconds,
                    "launches": launches, "max_abs_err_vs_unsharded": err,
                    **latency_ms([lat for _, _, lat in served])})
        del sm, ref
        torch.cuda.empty_cache()

    tt_cfg = two_tower_config(ett)
    model = ett.init_two_tower(tt_cfg, torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    G.gather_rows.launches = 0
    svc = ett.make_retrieval_service(model, k=10, mesh=mesh, max_batch=256,
                                     max_latency_ms=2.0)
    if rank != 0:
        torch.cuda.synchronize()
        out.append({"service": "retrieval", "followed_batches": svc.batches,
                    "launches": G.gather_rows.launches})
        return out

    def make_req(rng, b):
        return (rng.standard_normal((b, 4)).astype(np.float32),
                np.stack([rng.integers(0, v, b) for v in
                          tt_cfg.query_vocab_sizes]).astype(np.int32))
    t0 = time.perf_counter()
    try:
        served = closed_loop(svc, make_req, clients=4, per_client=8)
    finally:
        svc.stop()
    torch.cuda.synchronize()
    launches, seconds = G.gather_rows.launches, time.perf_counter() - t0
    stats = svc.stats_snapshot()
    tt = ett.models.two_tower
    with plain_gathers(G):
        index_p = tt.build_item_index(model)
        run10 = tt.make_retriever(model, k=10)
        near_ties, err = 0, 0.0
        for (dense, q_cat), (scores, ids), _ in served:
            ps, pi = run10(index_p, dense, q_cat)
            ps, pi = ps.cpu().numpy(), pi.cpu().numpy()
            np.testing.assert_allclose(scores, ps, rtol=1e-5, atol=1e-6)
            err = max(err, float(np.abs(scores - ps).max()))
            near_ties += retrieval_ids_match(ids, ps, pi)
    out.append({"service": "retrieval", "k": 10, "items": tt_cfg.item_vocab,
                "requests": len(served), "batches": stats["batches"],
                "seconds": seconds, "launches": launches,
                "scores_max_abs_vs_plain": err,
                "near_tie_positions": near_ties,
                **latency_ms([lat for _, _, lat in served])})
    del model, index_p
    torch.cuda.empty_cache()
    return out


def mesh_persistence(ett, P, S, G, mesh, rank, host, root):
    """Sharded persistence and eviction on the DLRM (26 x 250,000 x 128,
    SGD, B = 65,536 global) under `root`: a delta chain written on the mesh
    (a base of one part a rank, then deltas) restored into a single-device
    model, bitwise; a single-device chain restored into the mesh, bitwise;
    a guard rollback on a NaN batch on every rank, ending bitwise where the
    run without that batch ends; `evict_every=2` with the trackers replayed
    beside the loop (evicted rows zero, as many as the replay pops).
    Returns this rank's summary and launches."""
    import torch.distributed as dist
    from embeddingtables_tpu_torch.utils import (CheckpointManager,
                                                 DeltaCheckpointManager,
                                                 DivergenceGuard, rowstats)
    cfg = ett.dlrm_small_config(vocab=VOCAB)
    opt = ett.SparseSGD(1e-4)
    out = {}
    launches = {"gather_rows": 0, "scatter_add_rows_sorted": 0}

    def fresh(seed=SEED):
        return ett.init_dlrm(cfg, torch.Generator(device="cuda").manual_seed(
            seed), device="cuda", sparse_opt=opt)

    def counted(fn):
        G.gather_rows.launches = 0
        zero_scatter(S)
        got = fn()
        torch.cuda.synchronize()
        launches["gather_rows"] += G.gather_rows.launches
        launches["scatter_add_rows_sorted"] += scatter_count(S)
        return got

    def rows_equal(a, b, what):
        require(torch.equal(a.tables.data, b.tables.data) and all(
            torch.equal(x, y) for x, y in zip(a.emb_state, b.emb_state)),
            f"mesh persistence: {what} not bitwise")

    kw = dict(sparse_opt=opt, dense_lr=0.1, log_every=1, verbose=False,
              mesh=mesh)
    # A chain written on the mesh, restored into one device.
    t0 = time.perf_counter()
    mesh_dir = os.path.join(root, "mesh_chain")
    res = counted(lambda: ett.train_dlrm(
        cfg, iter(host[:3]), 3, model=fresh(), delta_ckpt=DeltaCheckpointManager(
            mesh_dir, base_every=8), delta_every=1, **kw))
    out["mesh_chain_write_s"] = time.perf_counter() - t0
    trained = P.unshard_dlrm(res.model)
    del res
    torch.cuda.empty_cache()
    if rank == 0:
        out["mesh_chain_files"] = sorted(os.listdir(mesh_dir))
        t0 = time.perf_counter()
        single = ett.restore_delta(DeltaCheckpointManager(mesh_dir),
                                   fresh(SEED + 1))
        torch.cuda.synchronize()
        out["mesh_chain_to_one_device_s"] = time.perf_counter() - t0
        rows_equal(single, trained, "mesh chain -> one device")
        del single
    del trained
    torch.cuda.empty_cache()
    dist.barrier()
    # A chain written on one device, restored into the mesh.
    flat_dir = os.path.join(root, "flat_chain")
    if rank == 0:
        single = fresh()
        counted(lambda: ett.train_dlrm(
            cfg, iter(host[:2]), 2, model=single,
            delta_ckpt=DeltaCheckpointManager(flat_dir, base_every=8),
            delta_every=1, sparse_opt=opt, dense_lr=0.1, log_every=1,
            verbose=False))
    dist.barrier()
    t0 = time.perf_counter()
    sm = P.shard_dlrm(fresh(SEED + 1), mesh, "data", sparse_opt=opt)
    ett.restore_delta(DeltaCheckpointManager(flat_dir), sm)
    torch.cuda.synchronize()
    out["one_device_chain_to_mesh_s"] = time.perf_counter() - t0
    back = P.unshard_dlrm(sm)
    del sm
    if rank == 0:
        rows_equal(back, single, "one-device chain -> mesh")
        del single
    del back
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        shutil.rmtree(mesh_dir, ignore_errors=True)
        shutil.rmtree(flat_dir, ignore_errors=True)
    # The guard: a NaN batch after a checkpoint at step 2.
    nan = dict(host[2], dense=np.full_like(host[2]["dense"], np.nan))
    mgr = CheckpointManager(os.path.join(root, "ckpt"))
    guard = DivergenceGuard(mgr)
    t0 = time.perf_counter()
    res = counted(lambda: ett.train_dlrm(
        cfg, iter([host[0], host[1], nan]), 3, model=fresh(),
        ckpt_manager=mgr, ckpt_every=2, guard=guard, **kw))
    out["guard_run_s"] = time.perf_counter() - t0
    require(guard.rollbacks == 1 and math.isnan(res.losses[2]),
            f"mesh guard: rollbacks {guard.rollbacks}, losses {res.losses}")
    rolled = P.unshard_dlrm(res.model)
    del res
    ref = counted(lambda: ett.train_dlrm(cfg, iter(host[:2]), 2,
                                         model=fresh(), **kw))
    want = P.unshard_dlrm(ref.model)
    del ref
    if rank == 0:
        rows_equal(rolled, want, "guard rollback")
        require(all(torch.equal(a, b) for a, b in zip(
            rolled.parameters(), want.parameters())),
            "mesh guard: towers not bitwise")
    out["guard_rollbacks"] = guard.rollbacks
    del rolled, want
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        shutil.rmtree(os.path.join(root, "ckpt"), ignore_errors=True)
    # Eviction every 2 steps, the trackers replayed.
    steps, every, threshold, decay = 4, 2, 0.3, 0.5
    res = counted(lambda: ett.train_dlrm(
        cfg, itertools.cycle(host), steps, model=fresh(), evict_every=every,
        evict_threshold=threshold, freq_decay=decay, **kw))
    trackers = [rowstats.FrequencyTracker(VOCAB, decay) for _ in range(26)]
    popped, last = 0, None
    for i in range(steps):
        for t, tr in enumerate(trackers):
            tr.observe(host[i % len(host)]["cat"][t])
        if (i + 1) % every == 0:
            last = np.concatenate([tr.pop_cold(threshold) + t * VOCAB
                                   for t, tr in enumerate(trackers)])
            popped += last.size
    require(res.evicted_rows == popped > 0 and last.size > 0,
            f"mesh eviction: evicted {res.evicted_rows}, replay {popped}")
    table = P.unshard_dlrm(res.model).tables.data
    require(not table[torch.from_numpy(last.astype(np.int64)).cuda()].any(),
            "mesh eviction: evicted rows not zero")
    out.update(evicted_rows=res.evicted_rows,
               last_eviction_rows=int(last.size))
    del res, table
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# Phase 16, planner part: replicated, row- and column-sharded tables in one
# model (`parallel/planner.py`)
# ---------------------------------------------------------------------------

# The 26 per-feature tables: Criteo Kaggle cardinalities capped at 250,000
# (about 1.78M rows). At D = 128 and the 4 MiB default, the 16 tables of
# 8,192 rows or fewer replicate; two of the 250,000-row tables column-shard.
PLANNER_VOCABS = tuple(min(c, VOCAB) for c in CRITEO_KAGGLE_CARDINALITIES)
PLANNER_COL = (2, 3)
PLANNER_STEPS = 3                   # timed steps per recipe, after a warm-up


def planner_recipes(ett):
    """(family, label, cfg, optimizer name, optimizer) of the planner part:
    the DLRM, DCN and folded DeepFM with SGD and indexer AdaGrad, and the
    DLRM with lazy Adam and FTRL, on the per-feature tables."""
    cfgs = (("dlrm", "dlrm", ett.dlrm_small_config(
                vocab_sizes=PLANNER_VOCABS)),
            ("dcn", "dcn", ett.dcn_small_config(vocab_sizes=PLANNER_VOCABS)),
            ("deepfm", "deepfm_folded", ett.deepfm_small_config(
                vocab_sizes=PLANNER_VOCABS)))
    out = []
    for family, label, cfg in cfgs:
        opts = (mesh_recipes(ett) if family == "dlrm"
                else mesh_family_opts(ett))
        out += [(family, label, cfg, name, opt) for name, opt in opts]
    return out


def planner_plan(P, mesh, n: int, dim: int):
    """The plan of the per-feature tables and how it was made: on more than
    one rank `plan_sharding(col_shard=PLANNER_COL)`; on one rank, where
    `plan_sharding` replicates every table, the same three placements by
    hand (small tables replicate, `PLANNER_COL` column-shard, the rest
    row-shard)."""
    if n > 1:
        return (P.plan_sharding(PLANNER_VOCABS, dim, mesh,
                                col_shard=list(PLANNER_COL)),
                "plan_sharding(col_shard=PLANNER_COL)")
    plan = P.plan_sharding(PLANNER_VOCABS, dim, mesh)
    places = [P.COL_SHARD if i in PLANNER_COL
              else P.REPLICATE if v * dim * 4 <= 4 << 20 else P.ROW_SHARD
              for i, v in enumerate(PLANNER_VOCABS)]
    return (by_hand(plan, places),
            "by hand: one rank's plan_sharding replicates every table")


def by_hand(plan, places):
    """`plan` with the given placements, one a table."""
    return dataclasses.replace(plan, decisions=tuple(
        dataclasses.replace(d, placement=p)
        for d, p in zip(plan.decisions, places)))


def planned_api(P, family):
    """(planned train step, planned eval step) of a family."""
    return {"dlrm": (P.make_planned_train_step, P.make_planned_eval_step),
            "dcn": (P.make_planned_dcn_train_step,
                    P.make_planned_dcn_eval_step),
            "deepfm": (P.make_planned_deepfm_train_step,
                       P.make_planned_deepfm_eval_step)}[family]


def planned_launches(name: str) -> dict:
    """A planned step's launches on each rank: one `gather_rows` a group for
    the lookups (replicated, row, column), and for the replicated group's
    gradient (`run_scatter_dense_grad`) one value permute and one
    run-scatter; SGD and indexer AdaGrad add the row group's permute and
    run-scatter (`owned_apply`); lazy Adam's and FTRL's row group and every
    column group sum with `index_add_` (more than 512 rows)."""
    dense = name in ("lazy_adam", "ftrl_l1")
    return {"gather_rows": 4 if dense else 5,
            "scatter_add_rows_sorted": 1 if dense else 2}


def repl_hash(pt) -> torch.Tensor:
    """An int64 hash of the replicated group's table and state bits: each
    32-bit word times its position (mod a prime) plus one, summed."""
    h = torch.zeros((), dtype=torch.int64, device="cuda")
    for x in [pt.repl] + [s for s in pt.repl_state if s.numel()]:
        w = x.contiguous().view(-1)
        w = (w.view(torch.int32) if w.element_size() == 4
             else w.view(torch.int16)).to(torch.int64)
        pos = torch.arange(w.numel(), device="cuda", dtype=torch.int64)
        h += (w * (pos % 1_000_003 + 1)).sum()
    return h


def repl_agree(pt) -> bool:
    """The replicated group's hash all-gathered: the same on every rank."""
    import torch.distributed as dist
    h = repl_hash(pt).reshape(1)
    out = [torch.zeros_like(h) for _ in range(dist.get_world_size())]
    dist.all_gather(out, h)
    return all(int(o) == int(out[0]) for o in out)


def planned_dense_tables(pt) -> torch.Tensor:
    """The planned tables as one stacked `(sum V, D)` table in plan order
    (a collective)."""
    return torch.cat(pt.tables())


def mesh_planner_steps(ett, P, S, G, mesh, rank, n, blocks, results):
    """Every planner recipe: the planned step (step ms, collective ms of
    every group's exchange, peak memory, launches a rank) and the uniform
    row-sharded step on the same tables beside it; the replicated group's
    bits compared over the ranks after the timed steps."""
    for family, label, cfg, name, opt in planner_recipes(ett):
        r0 = time.perf_counter()
        dim = cfg.stack_dim if family == "deepfm" else cfg.dim
        plan, how = planner_plan(P, mesh, n, dim)
        single = getattr(ett, f"init_{family}")(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda", sparse_opt=opt)
        model = P.plan_model(single, plan, mesh, opt)
        del single
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = planned_api(P, family)[0](cfg, mesh, sparse_opt=opt,
                                         dense_lr=0.1)
        pt = model.tables
        got = timed_sharded_steps(S, G, step, model, blocks, PLANNER_STEPS,
                                  exchanges=[pt.exchange] + [
                                      g.exchange for g in (pt.shard, pt.col)
                                      if g is not None])
        agree = repl_agree(pt)
        planned = {"losses": got["losses"], "step_ms": got["step_ms"],
                   "launches": got["launches"],
                   "collective_ms": got["collective_ms"],
                   "peak_memory_gb": got["peak_memory_gb"],
                   "replicated_bitwise_across_ranks": agree,
                   "per_step": planned_launches(name)}
        del model, step, pt
        torch.cuda.empty_cache()
        shard = sharded_api(P, family)[0]
        single = getattr(ett, f"init_{family}")(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda", sparse_opt=opt)
        uniform = shard(single, mesh, "data", sparse_opt=opt)
        del single
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ustep = sharded_api(P, family)[1](cfg, mesh, "data", sparse_opt=opt,
                                          dense_lr=0.1)
        ugot = timed_sharded_steps(S, G, ustep, uniform, blocks,
                                   PLANNER_STEPS)
        dense = name in ("lazy_adam", "ftrl_l1")
        results.put({
            "kind": "planner", "rank": rank, "family": label,
            "recipe": name, "plan": how,
            "placements": {"replicated": len(plan.replicated),
                           "row_sharded": len(plan.sharded),
                           "col_sharded": len(plan.col_sharded)},
            "replicated_rows": sum(PLANNER_VOCABS[i]
                                   for i in plan.replicated),
            "cols_local": -(-dim // n), "planned": planned,
            "uniform": {"losses": ugot["losses"], "step_ms": ugot["step_ms"],
                        "launches": ugot["launches"],
                        "collective_ms": ugot["collective_ms"],
                        "peak_memory_gb": ugot["peak_memory_gb"],
                        "per_step": {"gather_rows": 1 if dense else 2,
                                     "scatter_add_rows_sorted":
                                         0 if dense else 1}},
            "seconds": time.perf_counter() - r0})
        del uniform, ustep
        torch.cuda.empty_cache()


def mesh_planner_parity(ett, P, mesh, rank, n, blocks, global_batches):
    """Two planned steps of every family (f32 towers) against two
    single-device steps from the same weights, SGD and indexer AdaGrad:
    rank 0 replays the global batches on one card; losses rtol 1e-5,
    tables and towers rtol 2e-4 / atol 1e-6 (JAX's planner tolerances: the
    replicated and column groups take the dense bodies, the single-device
    step the run-scatter); the replicated group bitwise equal over the
    ranks after every step. Lazy Adam and FTRL are held on the CPU
    (tests/test_torch_planner.py): a near-zero gradient whose sign another
    order of additions flips moves an Adam entry by about lr."""
    out = []
    for family, label, cfg, name, opt in planner_recipes(ett):
        if name in ("lazy_adam", "ftrl_l1"):
            continue
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        dim = cfg.stack_dim if family == "deepfm" else cfg.dim

        def fresh(cfg=cfg, family=family, opt=opt):
            return getattr(ett, f"init_{family}")(
                cfg, torch.Generator(device="cuda").manual_seed(SEED),
                device="cuda", sparse_opt=opt)
        plan, _ = planner_plan(P, mesh, n, dim)
        pm = P.plan_model(fresh(), plan, mesh, opt)
        step = planned_api(P, family)[0](cfg, mesh, sparse_opt=opt,
                                         dense_lr=0.1)
        losses, agree = [], []
        for b in blocks[:2]:
            losses.append(float(step(pm, *b)))
            agree.append(repl_agree(pm.tables))
        require(all(agree), f"planner parity {label} {name}: the replicated "
                "group differs between ranks")
        tables = planned_dense_tables(pm.tables)
        towers = [p.detach().clone() for _, p in pm.tower_params()]
        del pm
        torch.cuda.empty_cache()
        row = {"family": label, "recipe": name, "replicated_bitwise": agree}
        if rank == 0:
            single = fresh()
            step1 = getattr(ett.models, {
                "dlrm": "make_train_step", "dcn": "make_dcn_train_step",
                "deepfm": "make_deepfm_train_step"}[family])(
                    cfg, sparse_opt=opt, dense_lr=0.1)
            want = [float(step1(single, b["dense"], b["cat"], b["label"]))
                    for b in global_batches[:2]]
            torch.cuda.synchronize()
            np.testing.assert_allclose(losses, want, rtol=1e-5)
            pairs = [(tables, single.tables.data)] + list(zip(
                towers, [p.detach() for _, p in single.tower_params()]))
            for a, b in pairs:
                require(torch.allclose(a, b, rtol=2e-4, atol=1e-6),
                        f"planner parity {label} {name}: off by "
                        f"{max_abs_err(a, b)}")
            row.update(tolerance="losses rtol 1e-5, tables and towers rtol "
                       "2e-4 atol 1e-6", losses=losses, want=want,
                       max_abs_err=max(max_abs_err(a, b) for a, b in pairs))
            del single
        del tables, towers
        torch.cuda.empty_cache()
        out.append(row)
    return out


def mesh_planner_services(ett, P, G, mesh, rank, n):
    """The planned DLRM and DCN behind `make_dlrm_service(mesh=)` and
    `make_dcn_service(mesh=)` (f32 towers, 4 closed-loop clients x 8
    requests of 1-256 examples): every score the single-device eval's of
    the same weights on rank 0, rtol 1e-5. Rank 0 returns each service's
    summary, the others what they followed; with the `gather_rows`
    launches (three groups: three a batch)."""
    out = []
    for family in ("dlrm", "dcn"):
        cfg = dataclasses.replace(getattr(ett, f"{family}_small_config")(
            vocab_sizes=PLANNER_VOCABS), compute_dtype=torch.float32)
        plan, _ = planner_plan(P, mesh, n, cfg.dim)
        single = getattr(ett, f"init_{family}")(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda")
        pm = P.plan_model(single, plan, mesh)
        torch.cuda.synchronize()
        G.gather_rows.launches = 0
        svc = getattr(ett, f"make_{family}_service")(
            pm, mesh=mesh, max_batch=1024, max_latency_ms=2.0)
        if rank != 0:
            torch.cuda.synchronize()
            out.append({"service": family, "followed_batches": svc.batches,
                        "launches": G.gather_rows.launches})
            del pm, single
            torch.cuda.empty_cache()
            continue
        t0 = time.perf_counter()
        try:
            served = closed_loop(svc, lambda rng, b: make_request(rng, cfg,
                                                                  b),
                                 clients=4, per_client=8)
        finally:
            svc.stop()
        torch.cuda.synchronize()
        launches, seconds = G.gather_rows.launches, time.perf_counter() - t0
        ev = getattr(ett.models, {"dlrm": "make_eval_step",
                                  "dcn": "make_dcn_eval_step"}[family])(cfg)
        err = 0.0
        for (dense, cat), got, _ in served:
            want = ev(single, dense, cat).cpu().numpy()
            require(np.all(np.isfinite(got)), f"planned {family} service: "
                    "non-finite scores")
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            err = max(err, float(np.abs(got - want).max()))
        stats = svc.stats_snapshot()
        out.append({"service": family, "requests": len(served),
                    "batches": stats["batches"], "seconds": seconds,
                    "launches": launches, "max_abs_err_vs_unsharded": err,
                    **latency_ms([lat for _, _, lat in served])})
        del pm, single
        torch.cuda.empty_cache()
    return out


def mesh_planner_loop(ett, P, S, G, mesh, rank, n, host, root):
    """`train_dlrm(mesh=, plan=)` on every rank (SGD): a guard rollback on a
    NaN batch after a checkpoint at step 2, ending bitwise where the run
    without that batch ends (tables of every group, towers); then
    `evict_every=2` over 4 steps (finite losses, rows evicted, evicted
    rows zero). Returns this rank's summary and launches."""
    from embeddingtables_tpu_torch.utils import (CheckpointManager,
                                                 DivergenceGuard)
    cfg = ett.dlrm_small_config(vocab_sizes=PLANNER_VOCABS)
    opt = ett.SparseSGD(1e-4)
    plan, _ = planner_plan(P, mesh, n, cfg.dim)
    launches = {"gather_rows": 0, "scatter_add_rows_sorted": 0}

    def fresh():
        return ett.init_dlrm(cfg, torch.Generator(device="cuda").manual_seed(
            SEED), device="cuda", sparse_opt=opt)

    def counted(fn):
        G.gather_rows.launches = 0
        zero_scatter(S)
        got = fn()
        torch.cuda.synchronize()
        launches["gather_rows"] += G.gather_rows.launches
        launches["scatter_add_rows_sorted"] += scatter_count(S)
        return got

    kw = dict(sparse_opt=opt, dense_lr=0.1, log_every=1, verbose=False,
              mesh=mesh, plan=plan)
    nan = dict(host[2], dense=np.full_like(host[2]["dense"], np.nan))
    mgr = CheckpointManager(os.path.join(root, "planned_ckpt"))
    guard = DivergenceGuard(mgr)
    t0 = time.perf_counter()
    res = counted(lambda: ett.train_dlrm(
        cfg, iter([host[0], host[1], nan]), 3, model=fresh(),
        ckpt_manager=mgr, ckpt_every=2, guard=guard, **kw))
    out = {"guard_run_s": time.perf_counter() - t0,
           "guard_rollbacks": guard.rollbacks, "guard_losses": res.losses}
    require(guard.rollbacks == 1 and math.isnan(res.losses[2])
            and type(res.model).__name__ == "PlannedDLRM",
            f"planned guard: rollbacks {guard.rollbacks}, losses "
            f"{res.losses}")
    rolled = planned_dense_tables(res.model.tables)
    rolled_towers = [p.detach().clone() for _, p in
                     res.model.tower_params()]
    del res
    ref = counted(lambda: ett.train_dlrm(cfg, iter(host[:2]), 2,
                                         model=fresh(), **kw))
    require(torch.equal(rolled, planned_dense_tables(ref.model.tables))
            and all(torch.equal(a, b.detach()) for a, (_, b) in zip(
                rolled_towers, ref.model.tower_params())),
            "planned guard rollback: not bitwise the run without the NaN "
            "batch")
    del ref, rolled, rolled_towers
    torch.cuda.empty_cache()
    import torch.distributed as dist
    dist.barrier()
    if rank == 0:
        shutil.rmtree(os.path.join(root, "planned_ckpt"), ignore_errors=True)
    t0 = time.perf_counter()
    res = counted(lambda: ett.train_dlrm(
        cfg, itertools.cycle(host), 4, model=fresh(), evict_every=2,
        evict_threshold=0.3, freq_decay=0.5, **kw))
    table = planned_dense_tables(res.model.tables)
    zero = int((table == 0).all(dim=1).sum())
    require(all(math.isfinite(x) for x in res.losses)
            and res.evicted_rows > 0 and zero >= 1,
            f"planned eviction: losses {res.losses}, evicted "
            f"{res.evicted_rows}, zero rows {zero}")
    out.update(evict_run_s=time.perf_counter() - t0,
               evicted_rows=res.evicted_rows, zero_rows=zero,
               evict_losses=res.losses)
    del res, table
    torch.cuda.empty_cache()
    return out, launches


# ---------------------------------------------------------------------------
# Phase 16, planner part: the planned two-tower retriever and mixed dims
# ---------------------------------------------------------------------------

# The 100k-row query table column-shards; the 1k one replicates (256 KiB at
# D = 64), the 1M one and the 2M-item corpus row-shard.
TT_PLANNER_COL = (1,)
MIXED_SMALL = 8_192                 # tables of at most this many rows: D = 32


def tt_plans(P, mesh, n: int, dim: int):
    """(q_plan, i_plan, how) of the planned two-tower model: on more than
    one rank `plan_sharding(col_shard=TT_PLANNER_COL)` of the query tables
    and `plan_sharding([TT_ITEMS])` of the corpus; on one rank, where
    `plan_sharding` replicates every table, the same placements by hand."""
    qp = P.plan_sharding(TT_QUERY_VOCABS, dim, mesh,
                         col_shard=list(TT_PLANNER_COL))
    ip = P.plan_sharding([TT_ITEMS], dim, mesh)
    if n > 1:
        return qp, ip, ("plan_sharding(col_shard=TT_PLANNER_COL), "
                        "plan_sharding([TT_ITEMS])")
    return (by_hand(qp, (P.ROW_SHARD, P.COL_SHARD, P.REPLICATE)),
            by_hand(ip, (P.ROW_SHARD,)),
            "by hand: one rank's plan_sharding replicates every table")


# A planned two-tower step's launches on each rank (SGD and indexer AdaGrad):
# `gather_rows` for the four lookups (the query stack's replicated, row and
# column groups; the corpus's row group) and for the three value permutes of
# the replicated group's gradient and of the two row groups' updates; one
# run-scatter for each of those three. The 100k-row column group's update
# sums with `index_add_` (more than 512 rows).
PLANNED_TT_LAUNCHES = {"gather_rows": 7, "scatter_add_rows_sorted": 3}


def planned_tt_exchanges(pm) -> list:
    """Every exchange of a planned two-tower model's groups."""
    out = []
    for pt in (pm.query_tables, pm.item_tables):
        out.append(pt.exchange)
        out += [g.exchange for g in (pt.shard, pt.col) if g is not None]
    return out


def tt_host_blocks(ett, P, mesh, cfg):
    """The two-tower phase's 4 host batches (B = 16,384 global), this
    rank's blocks of them on the card, and the global batches on the card."""
    host = list(ett.SyntheticRetrieval(
        cfg.query_vocab_sizes, cfg.item_vocab, num_dense=4,
        batch_size=TT_BATCH, seed=SEED + 20).batches(MESH_BATCHES))
    shardings = P.tt_batch_shardings(mesh, "data")
    keys = ("dense", "q_cat", "item_ids")
    blocks = [tuple(torch.from_numpy(np.ascontiguousarray(f(b[k]))).cuda()
                    for f, k in zip(shardings, keys)) for b in host]
    return host, blocks


def mesh_planner_tt(ett, P, S, G, mesh, rank, n, root, results):
    """The planned two-tower model at the repo's two-tower shape (1M / 100k
    / 1k query rows at D = 64, 2M items, MLPs 256-64, B = 16,384 global):
    SGD and indexer AdaGrad timed beside the uniform sharded step (launches
    a rank required exactly), two planned steps held to the single-device
    step, the planned index over every item against `build_item_index`,
    `planned_retrieve` against the plain retriever, and
    `train_two_tower(mesh=, plan=)` with a recall eval, `device_prefetch`
    and a checkpoint restored bitwise; each result put on `results`."""
    from embeddingtables_tpu_torch.utils import CheckpointManager
    tt = ett.models.two_tower
    cfg = two_tower_config(ett)
    qp, ip, how = tt_plans(P, mesh, n, cfg.dim)
    host, blocks = tt_host_blocks(ett, P, mesh, cfg)
    keys = ("dense", "q_cat", "item_ids")

    def fresh(opt):
        return ett.init_two_tower(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda", sparse_opt=opt)

    for name, opt in mesh_family_opts(ett):
        r0 = time.perf_counter()
        single = fresh(opt)
        pm = P.place_two_tower_on_plan(qp, ip, mesh, single, opt)
        del single
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step = P.make_planned_tt_train_step(cfg, mesh, sparse_opt=opt,
                                            dense_lr=0.1)
        got = timed_sharded_steps(S, G, step, pm, blocks, MESH_FAMILY_STEPS,
                                  exchanges=planned_tt_exchanges(pm))
        agree = repl_agree(pm.query_tables)
        del pm, step
        torch.cuda.empty_cache()
        single = fresh(opt)
        uniform = P.shard_two_tower(single, mesh, "data", sparse_opt=opt)
        del single
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ustep = P.make_sharded_tt_train_step(cfg, mesh, "data",
                                             sparse_opt=opt, dense_lr=0.1)
        ugot = timed_sharded_steps(S, G, ustep, uniform, blocks,
                                   MESH_FAMILY_STEPS)
        del uniform, ustep
        torch.cuda.empty_cache()
        results.put({
            "kind": "planner_tt", "rank": rank, "recipe": name, "plan": how,
            "q_placements": [d.placement for d in qp.decisions],
            "i_placements": [d.placement for d in ip.decisions],
            "cols_local": -(-cfg.dim // n),
            "planned": dict(got, replicated_bitwise_across_ranks=agree,
                            per_step=PLANNED_TT_LAUNCHES),
            "uniform": dict(ugot, per_step=family_launches("two_tower",
                                                           cfg)),
            "seconds": time.perf_counter() - r0})

    # Two planned steps against two single-device steps (rank 0 replays the
    # global batches on one card).
    rows = []
    for name, opt in mesh_family_opts(ett):
        pm = P.place_two_tower_on_plan(qp, ip, mesh, fresh(opt), opt)
        step = P.make_planned_tt_train_step(cfg, mesh, sparse_opt=opt,
                                            dense_lr=0.1)
        losses, agree = [], []
        for b in blocks[:2]:
            losses.append(float(step(pm, *b)[0]))
            agree.append(repl_agree(pm.query_tables))
        require(all(agree), f"planned two-tower parity {name}: the "
                "replicated group differs between ranks")
        got = [torch.cat(pm.query_tables.tables()),
               pm.item_tables.tables()[0]] + [
                   p.detach().clone() for p in pm.parameters()]
        del pm, step
        torch.cuda.empty_cache()
        row = {"recipe": name, "replicated_bitwise": agree}
        if rank == 0:
            single = fresh(opt)
            step1 = tt.make_train_step(cfg, sparse_opt=opt, dense_lr=0.1)
            want = []
            for b in host[:2]:
                want.append(float(step1(single, *(
                    torch.from_numpy(b[k]).cuda() for k in keys))[0]))
            torch.cuda.synchronize()
            pairs = list(zip(got, [single.query_tables.data,
                                   single.item_data]
                             + [p.detach() for p in single.parameters()]))
            np.testing.assert_allclose(losses, want, rtol=1e-4)
            for a, b in pairs:
                require(torch.allclose(a, b, rtol=5e-4, atol=1e-5),
                        f"planned two-tower parity {name}: off by "
                        f"{max_abs_err(a, b)}")
            row.update(tolerance="losses rtol 1e-4, tables and towers rtol "
                       "5e-4 atol 1e-5", losses=losses, want=want,
                       bitwise=losses == want and all(
                           torch.equal(a, b) for a, b in pairs),
                       max_abs_err=max(max_abs_err(a, b) for a, b in pairs))
            del single
        del got
        torch.cuda.empty_cache()
        rows.append(row)
    results.put({"kind": "planner_tt_parity", "rank": rank, "rows": rows})

    # The planned index over every item (whole on every rank) and the
    # planned retrieval, against the single-device ones from the same
    # weights on rank 0.
    opt = ett.SparseSGD(1e-4)
    single = fresh(opt)
    pm = P.place_two_tower_on_plan(qp, ip, mesh, single, opt)
    torch.cuda.synchronize()
    G.gather_rows.launches = 0
    t0 = time.perf_counter()
    index = P.planned_build_item_index(mesh, pm)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    index_launches = G.gather_rows.launches
    e = ett.SyntheticRetrieval(cfg.query_vocab_sizes, cfg.item_vocab,
                               num_dense=4, batch_size=TT_EVAL_BATCH,
                               seed=SEED + 21).batches(1)
    e = {k: torch.from_numpy(v).cuda() for k, v in next(iter(e)).items()}
    torch.cuda.synchronize()
    G.gather_rows.launches = 0
    t0 = time.perf_counter()
    ps, pi = P.planned_retrieve(mesh, pm, index, e["dense"], e["q_cat"],
                                k=10)
    torch.cuda.synchronize()
    retrieve_s = time.perf_counter() - t0
    retrieve_launches = G.gather_rows.launches
    serve = {"index_s": index_s, "index_launches": index_launches,
             "retrieve_s": retrieve_s, "retrieve_launches": retrieve_launches,
             "queries": TT_EVAL_BATCH}
    if rank == 0:
        want = tt.build_item_index(single)
        index_err = max_abs_err(index, want)
        require(torch.allclose(index, want, rtol=1e-5, atol=1e-6),
                f"planned index: off by {index_err}")
        ws, wi = tt.retrieve(single, index, e["dense"], e["q_cat"], k=10)
        torch.cuda.synchronize()
        same = all(set(a) == set(b) for a, b in zip(pi.tolist(),
                                                    wi.tolist()))
        require(same and torch.allclose(ps, ws, rtol=1e-5, atol=1e-6),
                "planned_retrieve: not the plain retriever's ids")
        serve.update(index_max_abs_err=index_err,
                     index_bitwise=torch.equal(bits(index), bits(want)),
                     retrieve_ids_equal=torch.equal(pi, wi),
                     retrieve_max_abs_err=max_abs_err(ps, ws))
        del want
    del single, pm, index
    torch.cuda.empty_cache()
    results.put({"kind": "planner_tt_serve", "rank": rank, **serve})

    # The planned loop: a recall eval, device prefetch and a checkpoint at
    # step 4, restored bitwise into a fresh planned model.
    opt = ett.SparseSGD(0.05)
    ckpt = os.path.join(root, "planned_tt_ckpt")
    mgr = CheckpointManager(ckpt)
    G.gather_rows.launches = 0
    zero_scatter(S)
    t0 = time.perf_counter()
    res = ett.train_two_tower(
        cfg, itertools.cycle(host), 4, model=fresh(opt), mesh=mesh,
        plan=(qp, ip), sparse_opt=opt, seed=SEED, eval_every=4, k=10,
        eval_batches=[{k: v.cpu().numpy() for k, v in e.items()}],
        log_every=1, ckpt_manager=mgr, ckpt_every=4, device_prefetch=2,
        verbose=False)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = {"gather_rows": G.gather_rows.launches,
                "scatter_add_rows_sorted": scatter_count(S)}
    restored = P.init_planned_two_tower(cfg, qp, ip, mesh, sparse_opt=opt,
                                        seed=SEED + 1)
    mgr.restore_latest(restored)
    same = all(torch.equal(a, b) for a, b in zip(
        restored.state_dict().values(), res.model.state_dict().values()))
    require(type(res.model).__name__ == "PlannedTwoTower" and same
            and all(math.isfinite(x) for x in res.losses)
            and len(res.recalls) == 1,
            f"planned train_two_tower: {type(res.model).__name__}, restored "
            f"bitwise {same}, losses {res.losses}, recalls {res.recalls}")
    del res, restored
    torch.cuda.empty_cache()
    import torch.distributed as dist
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    results.put({"kind": "planner_tt_loop", "rank": rank, "loop_s": loop_s,
                 "launches": launches, "checkpoint_restored_bitwise": same,
                 "steps": 4})


def mixed_plans(P, mesh, n: int):
    """(plans, groups, dims, how) of the mixed-dim per-feature tables: the
    16 tables of at most `MIXED_SMALL` rows at D = 32, the 10 larger ones
    at D = 128, by `plan_sharding_mixed` (the D = 32 group replicates, the
    D = 128 group row-shards); on one rank, where every table replicates,
    the D = 128 group row-sharded by hand."""
    dims = tuple(32 if v <= MIXED_SMALL else 128 for v in PLANNER_VOCABS)
    plans, groups = P.plan_sharding_mixed(PLANNER_VOCABS, dims, mesh)
    if n > 1:
        return plans, groups, dims, "plan_sharding_mixed"
    return ((plans[0], by_hand(plans[1], [P.ROW_SHARD] * len(groups[1]))),
            groups, dims, "plan_sharding_mixed, the D = 128 group "
            "row-sharded by hand on one rank")


def rounding_bound(ett, opt, ids, delta, v: int, c: float = 2.0 ** -20):
    """A per-element bound `(v, D)` on the f32 rounding that another order
    of the run sums adds to one lazy update of a table of `v` rows from a
    fresh state: `c` (8 ulps) times each element's summed delta magnitude
    S, as the optimizer scales the sum g (SGD: lr * c * S; row-wise AdaGrad:
    lr * c * (S + |g| * mean(|g| S) / a) / sqrt(a + eps), a = mean(g^2),
    the second term the rms's own move). On more than one rank the row
    group's owned stream cuts its runs at other window edges than one
    device's stream does, so its sums round in another order."""
    r = ids.long()
    d = delta.shape[1]
    s = torch.zeros((v, d), dtype=torch.float64, device=delta.device
                    ).index_add_(0, r, delta.abs().double())
    if isinstance(opt, ett.SparseSGD):
        return (c * opt.lr * s).float()
    g = torch.zeros((v, d), dtype=torch.float64, device=delta.device
                    ).index_add_(0, r, delta.double())
    a = (g * g).mean(dim=1, keepdim=True)
    cross = (g.abs() * s).mean(dim=1, keepdim=True) / (a + opt.eps)
    return (c * opt.lr * (s + g.abs() * cross)
            * torch.rsqrt(a + opt.eps)).float()


def mesh_mixed(ett, P, S, G, mesh, rank, n, results):
    """Mixed dims on the 26 per-feature tables at B = 65,536 global:
    `mixed_planned_lookup` and `mixed_planned_apply` (SGD and indexer
    AdaGrad, JAX's test's rates, unit deltas) against each table's
    single-device `lookup` and `opt.apply` (rank 0; lookups bitwise, tables
    to JAX's rtol 2e-5 / atol 1e-6 plus `rounding_bound`: a Zipf row sums
    thousands of deltas), their times, and the launches a rank
    (`gather_rows` by width: one lookup and one value permute a group;
    one run-scatter a group) required exactly."""
    from embeddingtables_tpu_torch.ops.sparse_update import \
        SparseEmbeddingUpdate
    from embeddingtables_tpu_torch.parallel.sharded import Exchange
    plans, groups, dims, how = mixed_plans(P, mesh, n)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    tables = [torch.randn((v, d), generator=gen, device="cuda")
              for v, d in zip(PLANNER_VOCABS, dims)]
    b = next(iter(ett.SyntheticCriteo(vocab_sizes=PLANNER_VOCABS,
                                      batch_size=B_TRAIN,
                                      seed=SEED + 41).batches(1)))
    ids = torch.from_numpy(b["cat"]).cuda()
    deltas = [torch.randn((B_TRAIN, d), generator=gen, device="cuda")
              for d in dims]
    ex = Exchange(mesh, "data")
    sl = slice(ex.data_index * (B_TRAIN // ex.n_data),
               (ex.data_index + 1) * (B_TRAIN // ex.n_data))
    block = ids[:, sl]
    rows = []
    for name, opt in (("sgd", ett.SparseSGD(0.2)),
                      ("adagrad_indexer", ett.SparseRowWiseAdaGrad(
                          lr=0.1, eps=1e-6, method="indexer"))):
        mt = P.MixedDimPlannedTables.from_tables(plans, groups, mesh,
                                                 [t.clone() for t in tables],
                                                 sparse_opt=opt)
        torch.cuda.synchronize()
        G.gather_rows.launches = 0
        zero_scatter(S)
        G.gather_rows.widths.clear()
        start, mid, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
        start.record()
        looked = P.mixed_planned_lookup(mesh, mt, block)
        mid.record()
        P.mixed_planned_apply(mesh, mt, block, [d[sl] for d in deltas], opt)
        end.record()
        torch.cuda.synchronize()
        launches = {"gather_rows": G.gather_rows.launches,
                    "scatter_add_rows_sorted": scatter_count(S)}
        widths = {str(d): c for d, c in sorted(G.gather_rows.widths.items())}
        got = [ex.gather_batch(x.contiguous()) for x in looked]
        dense = [mt.table(t) for t in range(mt.ntables)]
        row = {"recipe": name, "launches": launches, "widths": widths,
               "lookup_ms": start.elapsed_time(mid),
               "apply_ms": mid.elapsed_time(end)}
        if rank == 0:
            look_err = table_err = worst = 0.0
            bitwise = True
            for t, table in enumerate(tables):
                want = ett.lookup(ett.SimpleEmbedding(table), ids[t])
                require(torch.equal(bits(got[t]), bits(want)),
                        f"mixed lookup table {t}: not bitwise")
                look_err = max(look_err, max_abs_err(got[t], want))
                upd = SparseEmbeddingUpdate(delta=deltas[t], indices=ids[t])
                new, _ = opt.apply(table.clone(), upd, opt.init(table))
                err = (dense[t] - new).abs()
                tol = 2e-5 * new.abs() + 1e-6 + rounding_bound(
                    ett, opt, ids[t], deltas[t], table.shape[0])
                require(bool((err <= tol).all()), f"mixed apply {name} table "
                        f"{t}: off by {float(err.max())}, "
                        f"{float((err / tol).max())} of the tolerance")
                table_err = max(table_err, float(err.max()))
                worst = max(worst, float((err / tol).max()))
                bitwise = bitwise and torch.equal(bits(dense[t]), bits(new))
            row.update(tolerance="lookups bitwise, tables rtol 2e-5 atol "
                       "1e-6 (JAX's) plus rounding_bound",
                       lookup_max_abs_err=look_err,
                       table_max_abs_err=table_err,
                       worst_share_of_tolerance=worst, bitwise=bitwise)
        del mt, looked, got, dense
        torch.cuda.empty_cache()
        rows.append(row)
    results.put({"kind": "planner_mixed", "rank": rank, "how": how,
                 "groups": [list(g) for g in groups],
                 "dims": sorted(set(dims)),
                 "placements": [[d.placement for d in p.decisions]
                                for p in plans],
                 "batch": B_TRAIN, "rows": rows})


def mesh_planner(ett, P, S, G, mesh, rank, n, root, results):
    """The planner part of the mesh phase on the per-feature tables at B =
    65,536 global (4 cycled Zipf(1.1) batches): the plans (and the one
    `skew_from_trackers` would choose), every recipe against the uniform
    row-sharded step, the parity runs, the DLRM and DCN planned services
    and the planned loop; then the same tables at mixed dims
    (`mesh_mixed`) and the planned two-tower model (`mesh_planner_tt`);
    each result put on `results`."""
    import types
    from embeddingtables_tpu_torch.utils import FrequencyTracker
    host = list(ett.SyntheticCriteo(vocab_sizes=PLANNER_VOCABS,
                                    batch_size=B_TRAIN,
                                    seed=SEED + 30).batches(MESH_BATCHES))
    blocks = [tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda()
                    for x in P.local_batch(mesh, "data", b["dense"], b["cat"],
                                           b["label"])) for b in host]
    trackers = [FrequencyTracker(v) for v in PLANNER_VOCABS]
    for b in host:
        for t, tr in enumerate(trackers):
            tr.observe(b["cat"][t])
    skew = P.skew_from_trackers(trackers)
    plan, how = planner_plan(P, mesh, n, 128)
    four = types.SimpleNamespace(mesh_dim_names=("data",), shape=(4,))
    if rank == 0:
        results.put({"kind": "planner_plan", "rank": rank, "how": how,
                     "summary": plan.summary(),
                     "skew": [round(s, 4) for s in skew],
                     "skew_plan_here": P.plan_sharding(
                         PLANNER_VOCABS, 128, mesh, skew=skew).summary(),
                     "skew_plan_on_4_ranks": P.plan_sharding(
                         PLANNER_VOCABS, 128, four, skew=skew).summary()})
    mesh_planner_steps(ett, P, S, G, mesh, rank, n, blocks, results)
    global_batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                      for b in host[:2]]
    results.put({"kind": "planner_parity", "rank": rank,
                 "rows": mesh_planner_parity(ett, P, mesh, rank, n, blocks,
                                             global_batches)})
    del global_batches
    torch.cuda.empty_cache()
    results.put({"kind": "planner_service", "rank": rank,
                 "rows": mesh_planner_services(ett, P, G, mesh, rank, n)})
    summary, launches = mesh_planner_loop(ett, P, S, G, mesh, rank, n, host,
                                          root)
    results.put({"kind": "planner_loop", "rank": rank, "launches": launches,
                 **summary})
    del host, blocks
    torch.cuda.empty_cache()
    mesh_mixed(ett, P, S, G, mesh, rank, n, results)
    mesh_planner_tt(ett, P, S, G, mesh, rank, n, root, results)


def col_width_kernels(ett, G, gen):
    """`gather_rows` at the planner's column widths: the column group of
    the two 250,000-row tables (`PLANNER_COL`, 500,000 rows) gathered by
    the whole batch's ids of those tables (2 x 65,536 Zipf(1.1) ids, the
    (table, example) pairs batch-major) at `cols_local` = 32 (D = 128 on
    four cards) and 33 (the folded DeepFM's 129 padded to 132): bitwise its
    plain version (with wrapped and out-of-range ids), and timed beside the
    plain version, `F.embedding` and the byte bound. Returns (largest
    error, {"d32": times, "d33": times})."""
    t0 = time.perf_counter()
    offs = np.cumsum([0] + [PLANNER_VOCABS[i] for i in PLANNER_COL])
    sets = []
    for b in ett.SyntheticCriteo(vocab_sizes=PLANNER_VOCABS,
                                 batch_size=B_TRAIN,
                                 seed=SEED + 31).batches(3):
        ids = np.stack([b["cat"][i] + offs[j]
                        for j, i in enumerate(PLANNER_COL)], axis=1)
        sets.append(torch.from_numpy(ids.reshape(-1).astype(
            np.int32)).cuda())
    v = int(offs[-1])
    err, times = 0.0, {}
    for d in (32, 33):
        tab = torch.randn((v, d), generator=gen, device="cuda")
        ids = with_specials(sets[0].clone(), v, gen)
        got, want = G.gather_rows(tab, ids), G.gather_rows_plain(tab, ids)
        torch.cuda.synchronize()
        require(torch.equal(bits(got), bits(want)),
                f"gather_rows D={d} (column slice) not bitwise")
        emit({"phase": "kernel_check", "kernel": "gather_rows",
              "stream": "planner_col_zipf", "dtype": "float32", "V": v,
              "D": d, "n": ids.numel(), "bitwise": True})
        del tab, got, want
        times[f"d{d}"] = time_gather(G, gen, sets, v, d,
                                     f"planner_col_zipf_d{d}")
        torch.cuda.empty_cache()
    emit({"phase": "col_width_times", "n": sets[0].numel(), "V": v,
          **{k: {"kernel_ms": t["kernel_ms"], "bound_ms": t["bound_ms"],
                 "share_of_bound": t["bound_ms"] / t["kernel_ms"],
                 "library_ms": t["library_ms"], "plain_ms": t["plain_ms"]}
             for k, t in times.items()},
          "seconds": time.perf_counter() - t0})
    return err, times


def planner_rest_kernels(ett, G, gen):
    """`gather_rows` at the shapes of the planned two-tower model and the
    mixed dims, each bitwise its plain version (with wrapped and
    out-of-range ids) and timed beside the plain version, `F.embedding`
    and the byte bound: the 2M-item corpus at D = 64 by a step's 16,384
    item ids and by the index build's 65,536-id chunks; the 100k query
    table's column slice at D = 16 (its width on four cards) by a step's
    16,384 ids; the mixed replicated group at D = 32 (the 16 small tables
    stacked) by one card's 16 x 65,536 ids. Returns {key: times}."""
    t0 = time.perf_counter()
    tt_host = list(ett.SyntheticRetrieval(
        TT_QUERY_VOCABS, TT_ITEMS, num_dense=4, batch_size=TT_BATCH,
        seed=SEED + 20).batches(3))
    small = [i for i, v in enumerate(PLANNER_VOCABS) if v <= MIXED_SMALL]
    offs = np.cumsum([0] + [PLANNER_VOCABS[i] for i in small])
    mixed = []
    for b in ett.SyntheticCriteo(vocab_sizes=PLANNER_VOCABS,
                                 batch_size=B_TRAIN,
                                 seed=SEED + 41).batches(3):
        mixed.append(torch.from_numpy(np.stack(
            [b["cat"][i] + offs[j] for j, i in enumerate(small)]).reshape(
                -1).astype(np.int32)).cuda())

    def cuda_ids(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(
            np.int32)).cuda()
    cases = (
        ("tt_items_d64", [cuda_ids(b["item_ids"]) for b in tt_host],
         TT_ITEMS, 64),
        ("tt_index_d64", [torch.arange(lo, lo + 65_536, dtype=torch.int32,
                                       device="cuda")
                          for lo in (0, (TT_ITEMS - 65_536) // 2,
                                     TT_ITEMS - 65_536)],
         TT_ITEMS, 64),
        ("tt_qcol_d16", [cuda_ids(b["q_cat"][1]) for b in tt_host],
         TT_QUERY_VOCABS[1], 16),
        ("mixed_d32", mixed, int(offs[-1]), 32))
    times = {}
    for key, sets, v, d in cases:
        tab = torch.randn((v, d), generator=gen, device="cuda")
        ids = with_specials(sets[0].clone(), v, gen)
        got, want = G.gather_rows(tab, ids), G.gather_rows_plain(tab, ids)
        torch.cuda.synchronize()
        require(torch.equal(bits(got), bits(want)),
                f"gather_rows {key} not bitwise")
        emit({"phase": "kernel_check", "kernel": "gather_rows",
              "stream": key, "dtype": "float32", "V": v, "D": d,
              "n": ids.numel(), "bitwise": True})
        del tab, got, want
        times[key] = time_gather(G, gen, sets, v, d, key)
        torch.cuda.empty_cache()
    emit({"phase": "planner_rest_times",
          **{k: {"kernel_ms": t["kernel_ms"], "bound_ms": t["bound_ms"],
                 "share_of_bound": t["bound_ms"] / t["kernel_ms"],
                 "library_ms": t["library_ms"], "plain_ms": t["plain_ms"]}
             for k, t in times.items()},
          "seconds": time.perf_counter() - t0})
    return times


def mesh_rank(rank: int, n: int, port: int, root: str, results,
              planner_only: bool = False):
    """One rank of the mesh phase, on card `rank`: every recipe, the parity
    runs and the service of the DLRM, then the other families, their
    parity runs and services, sharded persistence under `root`, and the
    planner part (`mesh_planner`; alone with `planner_only`), each result
    put on `results`."""
    import datetime
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch import parallel as P
    from embeddingtables_tpu_torch.ops.cuda import gather as G
    from embeddingtables_tpu_torch.ops.cuda import scatter as S
    from embeddingtables_tpu_torch.parallel import sharded as PS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P.init_process(f"tcp://localhost:{port}", n, rank,
                   timeout=datetime.timedelta(seconds=600))
    mesh = P.local_mesh(n)
    if planner_only:
        mesh_planner(ett, P, S, G, mesh, rank, n, root, results)
        results.put({"kind": "scatter_classes", "rank": rank,
                     "classes": dict(SCATTER_CLASSES)})
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
        return
    ex = PS.Exchange(mesh, "data")
    cfg = ett.dlrm_small_config(vocab=VOCAB)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    data = ett.SyntheticCriteo(vocab_sizes=cfg.vocab_sizes,
                               batch_size=B_TRAIN, seed=SEED + 6)
    host = list(data.batches(MESH_BATCHES))
    global_batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                      for b in host]
    blocks = [tuple(torch.from_numpy(np.ascontiguousarray(x)).cuda()
                    for x in P.local_batch(mesh, "data", b["dense"], b["cat"],
                                           b["label"])) for b in host]
    b_local = blocks[0][0].shape[0]
    for name, opt in mesh_recipes(ett):
        for exchange in ("gather", "a2a"):
            r0 = time.perf_counter()
            model = P.shard_dlrm(ett.init_dlrm(cfg, torch.Generator(
                device="cuda").manual_seed(SEED), device="cuda",
                sparse_opt=opt), mesh, "data", sparse_opt=opt)
            torch.cuda.empty_cache()
            # The peak is the training's: the full model made before the
            # shard is gone.
            torch.cuda.reset_peak_memory_stats()
            step = P.make_sharded_train_step(
                cfg, mesh, "data", sparse_opt=opt, dense_lr=0.1,
                exchange=exchange, capacity_factor=MESH_CAPACITY,
                with_overflow=exchange == "a2a")
            outs = [step(model, *blocks[0])]                  # warm-up
            torch.cuda.synchronize()
            G.gather_rows.launches = 0
            zero_scatter(S)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for i in range(MESH_STEPS):
                outs.append(step(model, *blocks[(i + 1) % MESH_BATCHES]))
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / MESH_STEPS * 1e3
            launches = {"gather_rows": G.gather_rows.launches,
                        "scatter_add_rows_sorted": scatter_count(S)}
            losses = [float(o[0] if isinstance(o, tuple) else o)
                      for o in outs]
            overflow = [int(o[1]) for o in outs if isinstance(o, tuple)]
            timer = CollectiveTimer()
            model.tables.exchange.timer = timer
            step(model, *blocks[0])
            collectives = timer.totals()
            model.tables.exchange.timer = None
            tower_params = sum(p.numel() for _, p in model.tower_params())
            results.put({
                "kind": "recipe", "rank": rank, "recipe": name,
                "exchange": exchange, "losses": losses,
                "step_ms": start.elapsed_time(end) / MESH_STEPS,
                "host_wall_ms": wall, "launches": launches,
                "overflow": overflow,
                "overflow_fraction": (sum(overflow) / (
                    len(overflow) * 2 * B_TRAIN * cfg.num_tables)
                    if overflow else None),
                "collective_ms": collectives,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "shard_rows": model.tables.rows_local,
                "exchange_bytes": exchange_bytes(
                    ex, exchange, b_local, cfg.num_tables, cfg.dim,
                    tower_params),
                "seconds": time.perf_counter() - r0})
            del model, step, outs
    results.put({"kind": "parity", "rank": rank, "rows": mesh_parity(
        ett, P, mesh, rank, n, cfg32, blocks, global_batches)})
    summary, launches = mesh_service(ett, P, mesh, rank, cfg32, blocks)
    results.put({"kind": "service", "rank": rank, "launches": launches,
                 **summary})
    del global_batches
    torch.cuda.empty_cache()
    tt_cfg = two_tower_config(ett)
    tt_host = list(ett.SyntheticRetrieval(
        tt_cfg.query_vocab_sizes, tt_cfg.item_vocab, num_dense=4,
        batch_size=TT_BATCH, seed=SEED + 20).batches(MESH_BATCHES))
    shardings = P.tt_batch_shardings(mesh, "data")
    tt_blocks = [tuple(torch.from_numpy(np.ascontiguousarray(f(b[k]))).cuda()
                       for f, k in zip(shardings, ("dense", "q_cat",
                                                   "item_ids")))
                 for b in tt_host]
    mesh_families(ett, P, S, G, mesh, rank, blocks, tt_blocks, results)
    global_batches = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                      for b in host[:2]]
    tt_global = [{k: torch.from_numpy(v).cuda() for k, v in b.items()}
                 for b in tt_host[:2]]
    results.put({"kind": "family_parity", "rank": rank,
                 "rows": mesh_family_parity(ett, P, mesh, rank, n, blocks,
                                            global_batches, tt_blocks,
                                            tt_global)})
    del global_batches, tt_global
    torch.cuda.empty_cache()
    results.put({"kind": "family_service", "rank": rank,
                 "rows": mesh_family_services(ett, P, G, mesh, rank,
                                              blocks)})
    summary, launches = mesh_persistence(ett, P, S, G, mesh, rank, host,
                                         root)
    results.put({"kind": "persistence", "rank": rank, "launches": launches,
                 **summary})
    del blocks
    torch.cuda.empty_cache()
    mesh_planner(ett, P, S, G, mesh, rank, n, root, results)
    results.put({"kind": "scatter_classes", "rank": rank,
                 "classes": dict(SCATTER_CLASSES)})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_planner(got, n: int, total: dict) -> None:
    """The planner part's results: every recipe's losses finite and equal
    on every rank, its launches a rank exactly the planned step's (and the
    uniform step's), the replicated group bitwise equal over the ranks; the
    parity rows; the services' scores and followers; the loop's rollback
    and eviction. Adds the launches to `total`."""
    plans = [g for g in got if g["kind"] == "planner_plan"]
    require(len(plans) == 1, "planner: plan missing")
    rows = [g for g in got if g["kind"] == "planner"]
    require(len(rows) == n * 8, f"planner: {len(rows)} recipe results")
    for g in rows:
        lead = next(h for h in rows if h["rank"] == 0
                    and h["family"] == g["family"]
                    and h["recipe"] == g["recipe"])
        for kind in ("planned", "uniform"):
            r = g[kind]
            want = {k: v * PLANNER_STEPS for k, v in r["per_step"].items()}
            require(all(math.isfinite(x) for x in r["losses"]),
                    f"planner {kind} {g['family']} {g['recipe']}: losses "
                    f"{r['losses']}")
            require(r["losses"] == lead[kind]["losses"],
                    f"planner {kind} {g['family']} {g['recipe']}: ranks "
                    "disagree on losses")
            require(r["launches"] == want, f"planner {kind} {g['family']} "
                    f"{g['recipe']} rank {g['rank']}: launches "
                    f"{r['launches']}, want {want}")
            for k in total:
                total[k] += r["launches"][k]
        require(g["planned"]["replicated_bitwise_across_ranks"],
                f"planner {g['family']} {g['recipe']}: replicated group "
                "differs between ranks")
    parity = [g for g in got if g["kind"] == "planner_parity"
              and g["rank"] == 0]
    require(len(parity) == 1 and len(parity[0]["rows"]) == 6,
            "planner: parity results missing")
    services = sorted((g for g in got if g["kind"] == "planner_service"),
                      key=lambda g: g["rank"])
    require(len(services) == n, "planner: service results missing")
    for i, lead in enumerate(services[0]["rows"]):
        require(lead["requests"] == 32, f"planned {lead['service']} "
                f"service: {lead['requests']} requests")
        for s in services:
            row = s["rows"][i]
            require(row.get("followed_batches", lead["batches"])
                    == lead["batches"], f"planned {lead['service']} "
                    "service: followers missed batches")
            require(row["launches"] == 3 * lead["batches"],
                    f"planned {lead['service']} service rank {s['rank']}: "
                    f"gather_rows {row['launches']}, want "
                    f"{3 * lead['batches']}")
            total["gather_rows"] += row["launches"]
    loops = [g for g in got if g["kind"] == "planner_loop"]
    require(len(loops) == n and all(g["guard_rollbacks"] == 1
                                    and g["evicted_rows"] > 0
                                    for g in loops),
            "planner: loop results missing")
    for g in loops:
        for k in total:
            total[k] += g["launches"][k]
    check_planner_rest(got, n, total)


def check_planner_rest(got, n: int, total: dict) -> None:
    """The mixed-dim and planned two-tower results: launches a rank exactly
    (the mixed step's `gather_rows` at each width too), losses finite and
    equal on every rank, the replicated group bitwise over the ranks, the
    parity rows, the index's and retrieval's launches, the loop's restored
    checkpoint. Adds the launches to `total`."""
    mixed = [g for g in got if g["kind"] == "planner_mixed"]
    require(len(mixed) == n, "planner: mixed-dim results missing")
    for g in mixed:
        for row in g["rows"]:
            require(row["launches"] == {"gather_rows": 4,
                                        "scatter_add_rows_sorted": 2}
                    and row["widths"] == {"32": 2, "128": 2},
                    f"mixed {row['recipe']} rank {g['rank']}: launches "
                    f"{row['launches']}, by width {row['widths']}")
            for k in total:
                total[k] += row["launches"][k]
    rows = [g for g in got if g["kind"] == "planner_tt"]
    require(len(rows) == n * 2, f"planner: {len(rows)} two-tower results")
    for g in rows:
        lead = next(h for h in rows if h["rank"] == 0
                    and h["recipe"] == g["recipe"])
        for kind in ("planned", "uniform"):
            r = g[kind]
            want = {k: v * MESH_FAMILY_STEPS
                    for k, v in r["per_step"].items()}
            require(all(math.isfinite(x) for x in r["losses"])
                    and r["losses"] == lead[kind]["losses"],
                    f"planned two-tower {kind} {g['recipe']}: losses "
                    f"{r['losses']}")
            require(r["launches"] == want, f"planned two-tower {kind} "
                    f"{g['recipe']} rank {g['rank']}: launches "
                    f"{r['launches']}, want {want}")
            for k in total:
                total[k] += r["launches"][k]
        require(g["planned"]["replicated_bitwise_across_ranks"],
                f"planned two-tower {g['recipe']}: replicated group differs "
                "between ranks")
    parity = [g for g in got if g["kind"] == "planner_tt_parity"
              and g["rank"] == 0]
    require(len(parity) == 1 and len(parity[0]["rows"]) == 2,
            "planner: two-tower parity results missing")
    serve = [g for g in got if g["kind"] == "planner_tt_serve"]
    require(len(serve) == n and all(
        g["index_launches"] == -(-TT_ITEMS // 65_536)
        and g["retrieve_launches"] == 3 for g in serve),
        f"planned index / retrieval launches "
        f"{[(g['index_launches'], g['retrieve_launches']) for g in serve]}")
    total["gather_rows"] += sum(g["index_launches"] + g["retrieve_launches"]
                                for g in serve)
    loops = [g for g in got if g["kind"] == "planner_tt_loop"]
    require(len(loops) == n and all(g["checkpoint_restored_bitwise"]
                                    for g in loops),
            "planner: two-tower loop results missing")
    for g in loops:
        for k in total:
            total[k] += g["launches"][k]


def mesh_phase(ett, S, H, G, planner_only: bool = False):
    """The sharded DLRM (`dlrm_small_config(vocab=250_000)`, 26 x 250,000 x
    128, B = 65,536 global, Zipf(1.1) `SyntheticCriteo` batches) over every
    card of the machine, one rank per card in one NCCL group spawned from
    here: SGD, indexer AdaGrad, lazy Adam and FTRL on the gather exchange
    and the butterfly (capacity factor 2.0), each timed with its
    collectives, overflow, peak memory, bytes and per-rank launches; the
    parity runs (`mesh_parity`) and the service (`mesh_service`); then the
    other families, sharded persistence and the planner part
    (`mesh_planner`, alone with `planner_only`). The kernels are built
    before spawning (every rank loads that build). Returns the launches of
    the counted runs, summed over the ranks."""
    import tempfile
    import torch.multiprocessing as tmp
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    shm = shutil.disk_usage("/dev/shm")
    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    disk = shutil.disk_usage(root)
    require(disk.free > 12e9, f"mesh persistence needs 12 GB free under "
            f"{root}, has {disk.free / 1e9:.1f}")
    emit({"phase": "mesh_start", "ranks": n,
          "dev_shm_bytes": {"total": shm.total, "free": shm.free},
          "persistence_dir_free_bytes": disk.free,
          "nccl_version": str(torch.cuda.nccl.version()),
          "topology": subprocess.run(["nvidia-smi", "topo", "-m"],
                                     capture_output=True, text=True,
                                     timeout=60).stdout})
    torch.cuda.empty_cache()
    results = tmp.get_context("spawn").SimpleQueue()
    ranks = tmp.spawn(mesh_rank, args=(n, free_port(), root, results,
                                       planner_only),
                      nprocs=n, join=False)
    got = []
    done = False
    try:
        while not done:
            done = ranks.join(timeout=1)     # raises if a rank failed
            while not results.empty():
                got.append(results.get())
                # Each result as it arrives, so a later failure keeps it.
                emit({"phase": f"mesh_{got[-1]['kind']}", "ranks": n,
                      **{k: v for k, v in got[-1].items() if k != "kind"}})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for g in got:
        if g["kind"] == "scatter_classes":
            SCATTER_CLASSES.update(g["classes"])
    total = {"gather_rows": 0, "scatter_add_rows_sorted": 0}
    check_planner(got, n, total)
    if planner_only:
        emit({"phase": "mesh_done", "ranks": n, "batch": B_TRAIN,
              "launches": total, "seconds": time.perf_counter() - t0})
        return {"gather_bags": 0, "hot_accumulate": 0, **total}
    recipes = [g for g in got if g["kind"] == "recipe"]
    require(len(recipes) == n * 8, f"mesh: {len(recipes)} recipe results")
    for name, _ in mesh_recipes(ett):
        for exchange in ("gather", "a2a"):
            rows = sorted((g for g in recipes if g["recipe"] == name
                           and g["exchange"] == exchange),
                          key=lambda g: g["rank"])
            dense = name in ("lazy_adam", "ftrl_l1")
            per_step = {"gather_rows": (1 if exchange == "gather" else 2)
                        + (0 if dense else 1),
                        "scatter_add_rows_sorted": 0 if dense else 1}
            for g in rows:
                require(all(math.isfinite(x) for x in g["losses"]),
                        f"mesh {exchange} {name}: losses {g['losses']}")
                require(g["losses"] == rows[0]["losses"],
                        f"mesh {exchange} {name}: ranks disagree on losses")
                want = {k: v * MESH_STEPS for k, v in per_step.items()}
                require(g["launches"] == want, f"mesh {exchange} {name} rank "
                        f"{g['rank']}: launches {g['launches']}, want {want}")
                for k in total:
                    total[k] += g["launches"][k]
    parity = [g for g in got if g["kind"] == "parity" and g["rank"] == 0]
    require(len(parity) == 1 and len(parity[0]["rows"]) == 8,
            "mesh: parity results missing")
    service = sorted((g for g in got if g["kind"] == "service"),
                     key=lambda g: g["rank"])
    require(len(service) == n and service[0]["requests"] == 64,
            "mesh: service results missing")
    require(all(s["followed_batches"] == service[0]["batches"]
                for s in service[1:]), "mesh: followers missed batches")
    require(all(s["launches"] == service[0]["batches"] for s in service),
            "mesh service: gather_rows launches != served batches")
    total["gather_rows"] += sum(s["launches"] for s in service)
    families = [g for g in got if g["kind"] == "family"]
    require(len(families) == n * 8, f"mesh: {len(families)} family results")
    for g in families:
        want = {k: v * MESH_FAMILY_STEPS for k, v in g["per_step"].items()}
        require(all(math.isfinite(x) for x in g["losses"]),
                f"mesh {g['family']} {g['recipe']}: losses {g['losses']}")
        require(g["launches"] == want, f"mesh {g['family']} {g['recipe']} "
                f"rank {g['rank']}: launches {g['launches']}, want {want}")
        require(g["losses"] == next(
            h["losses"] for h in families if h["rank"] == 0
            and h["family"] == g["family"] and h["recipe"] == g["recipe"]),
            f"mesh {g['family']} {g['recipe']}: ranks disagree on losses")
        for k in total:
            total[k] += g["launches"][k]
    parity = [g for g in got if g["kind"] == "family_parity"
              and g["rank"] == 0]
    require(len(parity) == 1 and len(parity[0]["rows"]) == 8,
            "mesh: family parity results missing")
    services = sorted((g for g in got if g["kind"] == "family_service"),
                      key=lambda g: g["rank"])
    require(len(services) == n, "mesh: family service results missing")
    index_launches = -(-(-(-TT_ITEMS // n)) // 65_536)
    for i, lead in enumerate(services[0]["rows"]):
        require(lead["requests"] == 32, f"mesh {lead['service']} service: "
                f"{lead['requests']} requests")
        extra = index_launches if lead["service"] == "retrieval" else 0
        for s in services:
            row = s["rows"][i]
            require(row.get("followed_batches", lead["batches"])
                    == lead["batches"], f"mesh {lead['service']} service: "
                    "followers missed batches")
            require(row["launches"] == lead["batches"] + extra,
                    f"mesh {lead['service']} service rank {s['rank']}: "
                    f"gather_rows {row['launches']}, want "
                    f"{lead['batches'] + extra}")
            total["gather_rows"] += row["launches"]
    persist = [g for g in got if g["kind"] == "persistence"]
    require(len(persist) == n and all(g["guard_rollbacks"] == 1
                                      for g in persist),
            "mesh: persistence results missing")
    for g in persist:
        for k in total:
            total[k] += g["launches"][k]
    emit({"phase": "mesh_done", "ranks": n, "batch": B_TRAIN,
          "launches": total,
          "seconds": time.perf_counter() - t0})
    return {"gather_bags": 0, "hot_accumulate": 0, **total}


# ---------------------------------------------------------------------------
# Phase 17: compat, nn and the torch bridge in a stock torch loop
# ---------------------------------------------------------------------------

COMPAT_STEPS = 4


class CompatDLRM(torch.nn.Module):
    """A stock torch model: the DLRM's towers as parameters (stepped by
    `torch.optim.SGD`) and one `nn.SparseEmbed` per Criteo feature (stepped
    by `apply_sparse_updates`)."""

    def __init__(self, ett, cfg, model):
        super().__init__()
        self.cfg = cfg
        self.bottom_params = model.bottom_params
        self.top_params = model.top_params
        self.tables = torch.nn.ModuleList([
            ett.nn.SparseEmbed(v, cfg.dim, table=model.tables.table(t).data,
                               device="cuda")
            for t, v in enumerate(cfg.vocab_sizes)])

    def forward(self, dense, cat):
        from embeddingtables_tpu_torch.models.dlrm import (
            _pairs, forward_from_embeddings)
        emb = torch.stack([m(cat[t]) for t, m in enumerate(self.tables)])
        return forward_from_embeddings(_pairs(self.bottom_params),
                                       _pairs(self.top_params), self.cfg,
                                       dense, emb)


def compat_phase(ett, S, H, G):
    """A stock loop at B = 65,536: `torch.optim.SGD` on the DLRM's towers,
    26 `nn.SparseEmbed` tables with the Criteo Kaggle cardinalities capped
    at 250,000 through `sparse_updates_from_grads` and
    `apply_sparse_updates` (SGD: 26 lookups and 17 value permutes through
    `gather_rows`, 17 run-scatters and 9 `hot_accumulate`s a step), against the same steps with every kernel
    swapped for its plain version (tables to rtol 1e-5: `hot_accumulate`
    sums in another order; towers and losses to 1e-5); then
    `to_torch_embedding(bag=True)` of a trained table, an
    `nn.EmbeddingBag` on the card, against the table's `lookup`
    (`gather_bags`). Returns the launches of the counted run."""
    from embeddingtables_tpu_torch.models.dlrm import bce_loss
    t0 = time.perf_counter()
    vocabs = tuple(min(c, VOCAB) for c in CRITEO_KAGGLE_CARDINALITIES)
    cfg = ett.DLRMConfig(vocab_sizes=vocabs, compute_dtype=torch.float32)
    batches = criteo_batches(ett, vocabs, 2, SEED + 9)
    opt = ett.SparseSGD(1e-2)

    def train():
        model = CompatDLRM(ett, cfg, ett.init_dlrm(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda"))
        towers = torch.optim.SGD([p for n, p in model.named_parameters()],
                                 lr=1e-2)
        states, losses, counts, ms = None, [], [], []
        for i in range(COMPAT_STEPS):
            b = batches[i % len(batches)]
            G.gather_rows.launches = 0
            zero_scatter(S)
            H.hot_accumulate.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            towers.zero_grad()
            loss = bce_loss(model(b["dense"], b["cat"]), b["label"])
            loss.backward()
            upds = ett.nn.sparse_updates_from_grads(model)
            _, states = ett.nn.apply_sparse_updates(model, upds, opt, states)
            towers.step()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
            counts.append((G.gather_rows.launches, scatter_count(S),
                           H.hot_accumulate.launches))
            losses.append(float(loss.detach()))
        return model, losses, counts, ms

    model, losses, counts, ms = train()
    require(all(c == (43, 17, 9) for c in counts),
            f"compat: (gather_rows, run-scatter, hot_accumulate) launches "
            f"{counts}, want (43, 17, 9) a step")
    require(all(math.isfinite(x) for x in losses), f"compat: {losses}")
    with plain_gathers(G), plain_kernels(S, G), plain_segsum(H):
        plain, plain_losses, plain_counts, _ = train()
    require(all(c == (0, 0, 0) for c in plain_counts),
            "compat: the plain run launched kernels")
    np.testing.assert_allclose(losses, plain_losses, rtol=1e-5)
    err = 0.0
    for a, b in zip(model.tables, plain.tables):
        torch.testing.assert_close(a.table, b.table, rtol=1e-5, atol=1e-6)
        err = max(err, max_abs_err(a.table, b.table))
    for (_, a), (_, b) in zip(model.named_parameters(),
                              plain.named_parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # The bridge: a trained table as an nn.EmbeddingBag on the card.
    table = ett.SimpleEmbedding(model.tables[2].table)
    bag = ett.to_torch_embedding(table, bag=True, mode="sum")
    require(bag.weight.device.type == "cuda", "bridge: module off the card")
    ids = batches[0]["cat"][2].reshape(-1, 8)
    before = G.gather_bags.launches
    got = ett.lookup(table, ids)
    bag_launches = G.gather_bags.launches - before
    require(bag_launches == 1, "bridge: lookup did not launch gather_bags")
    want = bag(ids.long())
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=1e-6)
    emit({"phase": "compat", "batch": B_TRAIN, "tables": len(vocabs),
          "steps": COMPAT_STEPS, "losses": losses,
          "launches_per_step": {"gather_rows": 43,
                                "scatter_add_rows_sorted": 17,
                                "hot_accumulate": 9},
          "step_ms": ms, "max_abs_err_vs_plain": err,
          "embedding_bag_vs_lookup_max_abs": max_abs_err(got, want.detach()),
          "seconds": time.perf_counter() - t0})
    del model, plain
    torch.cuda.empty_cache()
    return {"gather_rows": 43 * COMPAT_STEPS, "gather_bags": 0,
            "scatter_add_rows_sorted": 17 * COMPAT_STEPS,
            "hot_accumulate": 9 * COMPAT_STEPS}


# ---------------------------------------------------------------------------
# Phase 19: the training command lines on the card
# ---------------------------------------------------------------------------

CLI_STEPS = 20
CLI_RUNS = (
    ("train_dlrm", ("--tables", "26", "--vocab", "250000", "--dim", "128")),
    ("train_dcn", ("--tables", "26", "--vocab", "250000", "--dim", "128")),
    ("train_deepfm", ()),
    ("train_two_tower", ()),
    ("train_dlrm", ("--tables", "26", "--vocab", "250000", "--dim", "128",
                    "--mesh", "--auto-shard")),
)


def cli_phase() -> list:
    """Each of the four command lines (`embeddingtables_tpu_torch/scripts/`)
    as its own process on the card for `CLI_STEPS` steps at its flags'
    defaults (the DLRM and DCN at 26 x 250,000 x 128), then `train_dlrm
    --mesh --auto-shard` on every card (it spawns one rank a card): each
    must exit 0 with finite losses whose last 5 average below the first
    5. The kernels are those `main` built; each process loads them."""
    import re
    out = []
    root = os.path.dirname(os.path.abspath(__file__))
    for module, flags in CLI_RUNS:
        cmd = [sys.executable, "-m",
               f"embeddingtables_tpu_torch.scripts.{module}", "--steps",
               str(CLI_STEPS), "--log-every", "1", *flags]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                           timeout=600)
        seconds = time.perf_counter() - t0
        losses = [float(x) for x in re.findall(
            r"^step\s+\d+\s+loss\s+(\S+)", p.stdout, re.M)]
        rate = re.findall(r"^([\d,]+) examples/s", p.stdout, re.M)
        row = {"phase": "cli", "command": " ".join(cmd[2:]), "rc":
               p.returncode, "seconds": seconds, "losses": losses,
               "examples_per_s": (int(rate[-1].replace(",", ""))
                                  if rate else None),
               "plan": [ln for ln in p.stdout.splitlines()
                        if ln.startswith("sharding plan")]}
        emit(row)
        require(p.returncode == 0, f"{module} {' '.join(flags)}: exit "
                f"{p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-4000:]}")
        require(len(losses) == CLI_STEPS
                and all(math.isfinite(x) for x in losses)
                and statistics.mean(losses[-5:]) < statistics.mean(
                    losses[:5]),
                f"{module} {' '.join(flags)}: losses {losses}")
        if "--auto-shard" in flags:
            require(len(row["plan"]) == 1, f"{module}: no plan printed")
        out.append(row)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch.ops.cuda import _lib
    from embeddingtables_tpu_torch.ops.cuda import gather as G
    from embeddingtables_tpu_torch.ops.cuda import scatter as S
    from embeddingtables_tpu_torch.ops.cuda import segsum as H

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _lib.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(p) for k, p in libs.items()},
          "ptxas": [ln.strip() for k in libs for ln in
                    _lib.build_log(k).splitlines() if "registers" in ln
                    or "spill" in ln]})

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    if "--run-window-sweep" in sys.argv[1:]:
        run_window_sweep(ett, S, gen)
        print(card_line(), flush=True)
        return 0
    if "--gather-sweep" in sys.argv[1:]:
        gather_sweep(ett, G, gen)
        print(card_line(), flush=True)
        return 0
    if "--per-table" in sys.argv[1:]:
        for segments in (128, 512):
            time_hot_accumulate(H, gen, segments)
        per_table_phase(ett, S, H, gen)
        print(card_line(), flush=True)
        return 0
    if "--ensemble" in sys.argv[1:]:
        ensemble_phase(ett, S, H, G, gen)
        print(card_line(), flush=True)
        return 0
    if "--multihot-dcn" in sys.argv[1:]:
        launches, err, t = multihot_dcn_phase(ett, S, H, G, gen)
        emit({"kernels": [ragged_kernel_row(
            launches["gather_bags_ragged"], err, t)]})
        print(card_line(), flush=True)
        return 0
    if "--wide-rows" in sys.argv[1:]:
        wide_rows_phase(ett, S, G, gen, LaunchCounter(S, H, G))
        print(card_line(), flush=True)
        return 0
    if "--scatter-widths" in sys.argv[1:]:
        scatter_widths_phase(ett, S, gen)
        print(card_line(), flush=True)
        return 0
    # The stacked training batches (26 x 250,000-row vocabularies, B =
    # 65,536): the DLRM, DCN and DeepFM recipes all train on them.
    train_batches = criteo_batches(ett, (VOCAB,) * 26, 4, SEED + 6)
    if "--families" in sys.argv[1:]:
        families_phase(ett, S, H, G, gen, train_batches)
        print(card_line(), flush=True)
        return 0
    if "--variants" in sys.argv[1:]:
        variants_phase(ett, S, H, G, gen, train_batches)
        print(card_line(), flush=True)
        return 0
    if "--persistence" in sys.argv[1:]:
        persistence_phase(ett, S, H, G, gen, train_batches)
        print(card_line(), flush=True)
        return 0
    if "--microbatch" in sys.argv[1:]:
        microbatch_phase(ett, S, H, G, train_batches)
        print(card_line(), flush=True)
        return 0
    if "--rpc" in sys.argv[1:]:
        rpc_phase(ett, S, H, G)
        print(card_line(), flush=True)
        return 0
    if "--input-pipeline" in sys.argv[1:]:
        input_pipeline_phase(ett, S, H, G)
        print(card_line(), flush=True)
        return 0
    if "--mesh" in sys.argv[1:]:
        mesh_phase(ett, S, H, G)
        print(card_line(), flush=True)
        return 0
    if "--planner" in sys.argv[1:]:
        col_width_kernels(ett, G, gen)
        planner_rest_kernels(ett, G, gen)
        mesh_phase(ett, S, H, G, planner_only=True)
        print(card_line(), flush=True)
        return 0
    if "--clis" in sys.argv[1:]:
        cli_phase()
        print(card_line(), flush=True)
        return 0
    if "--compat" in sys.argv[1:]:
        compat_phase(ett, S, H, G)
        print(card_line(), flush=True)
        return 0
    t0 = time.perf_counter()
    errs, timings = kernel_phase(G, gen)
    torch.cuda.empty_cache()
    emit({"phase": "gather_kernels", "seconds": time.perf_counter() - t0})

    cfg = ett.dlrm_small_config(vocab=250_000)
    t0 = time.perf_counter()
    model = ett.init_dlrm(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "table_bytes": model.tables.data.numel()
          * model.tables.data.element_size(),
          "table_shape": list(model.tables.data.shape),
          "compute_dtype": str(cfg.compute_dtype)})
    t0 = time.perf_counter()
    serve_launches = serving_phase(ett, G, model, cfg)
    throughput(ett, model, cfg)
    bag_launches, modelb, cfgb = multihot_phase(ett, G, model, cfg)
    throughput(ett, modelb, cfgb, bag=8)
    emit({"phase": "serving_done", "seconds": time.perf_counter() - t0})
    del model, modelb
    torch.cuda.empty_cache()

    update_errs, update_timings = update_kernel_phase(ett, S, H, G, gen)
    errs.update(update_errs)
    timings.update(update_timings)
    scatter_launches = stacked_training_phase(ett, S, H, G, train_batches)
    hot_launches = per_table_phase(ett, S, H, gen)
    ens = ensemble_phase(ett, S, H, G, gen)
    fam, fam_errs, fam_times = families_phase(ett, S, H, G, gen,
                                              train_batches)
    ragged = multihot_dcn_phase(ett, S, H, G, gen)
    torch.cuda.empty_cache()
    var = variants_phase(ett, S, H, G, gen, train_batches)
    wide_counter = LaunchCounter(S, H, G)
    wide_err, wide_times, _ = wide_rows_phase(ett, S, G, gen, wide_counter)
    widths_err, widths_times, per_call = scatter_widths_phase(ett, S, gen)
    persist, _ = persistence_phase(ett, S, H, G, gen, train_batches)
    micro = microbatch_phase(ett, S, H, G, train_batches)
    served_rpc = rpc_phase(ett, S, H, G)
    _, col_times = col_width_kernels(ett, G, gen)
    rest_times = planner_rest_kernels(ett, G, gen)
    meshed = mesh_phase(ett, S, H, G)
    compat = compat_phase(ett, S, H, G)
    cli_phase()
    # Last: loading the native libraries (built with -ffast-math, as the JAX
    # package builds them) sets flush-to-zero in this thread.
    piped = input_pipeline_phase(ett, S, H, G)
    for name, e in fam_errs.items():
        errs[name] = max(errs[name], e)
    errs["scatter_add_rows_sorted"] = max(errs["scatter_add_rows_sorted"],
                                          wide_err, widths_err)
    for d, t in wide_times.items():
        timings["scatter_add_rows_sorted"].update({
            f"d{d}_ms": t["sgd"]["kernel_ms"],
            f"d{d}_adagrad_ms": t["adagrad"]["kernel_ms"],
            f"d{d}_bound_ms": t["sgd"]["bound_ms"],
            f"d{d}_library_ms": t["sgd"]["library_ms"]})
    for key, t in widths_times.items():
        timings["scatter_add_rows_sorted"].update({
            f"{key}_ms": t["sgd"]["kernel_ms"],
            f"{key}_adagrad_ms": t["adagrad"]["kernel_ms"],
            f"{key}_bound_ms": t["sgd"]["bound_ms"],
            f"{key}_library_ms": t["sgd"]["library_ms"]})
    timings["scatter_add_rows_sorted"].update(
        kernels_per_call=per_call,
        launches_by_class=dict(SCATTER_CLASSES))
    for key, name, d in (("gather_rows", "gather_rows", 129),
                         ("gather_rows", "gather_rows", 1),
                         ("gather_bags", "gather_bags", 129),
                         ("scatter_add_rows_sorted", "scatter", 129),
                         ("scatter_add_rows_sorted", "scatter", 1)):
        t = fam_times[f"{name}_d{d}"]
        timings[key].update({f"d{d}_ms": t["kernel_ms"],
                             f"d{d}_bound_ms": t["bound_ms"],
                             f"d{d}_library_ms": t["library_ms"]})
    for key, t in ([(f"col_{k}", t) for k, t in col_times.items()]
                   + list(rest_times.items())):
        timings["gather_rows"].update({
            f"{key}_ms": t["kernel_ms"], f"{key}_plain_ms": t["plain_ms"],
            f"{key}_bound_ms": t["bound_ms"],
            f"{key}_library_ms": t["library_ms"]})

    csrc = "embeddingtables_tpu_torch/csrc/"
    pallas = "embeddingtables_tpu/ops/pallas/"
    counted = (ens, fam, ragged[0], var, wide_counter.total, persist, micro,
               served_rpc, meshed, compat, piped)
    paths = {
        "gather_rows": (serve_launches["gather_rows"]
                        + sum(c["gather_rows"] for c in counted),
                        "gather.cu", "gather.py:116"),
        "gather_bags": (bag_launches["gather_bags"]
                        + sum(c["gather_bags"] for c in counted),
                        "gather.cu", "gather.py:258"),
        "scatter_add_rows_sorted": (
            scatter_launches
            + sum(c["scatter_add_rows_sorted"] for c in counted),
            "scatter.cu", "scatter.py:144"),
        "hot_accumulate": (hot_launches
                           + sum(c["hot_accumulate"] for c in counted),
                           "segsum.cu", "segsum.py:135")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + source,
         "replaces": pallas + where, "launches": launches,
         "max_abs_err": errs[name],
         "ms": timings[name]["kernel_ms"], "plain_ms": timings[name]["plain_ms"],
         "bound_ms": timings[name]["bound_ms"],
         "bound_by": timings[name]["bound_by"],
         "library_ms": timings[name]["library_ms"],
         **{k: v for k, v in timings[name].items() if k not in (
             "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
        for name, (launches, source, where) in paths.items()]
        + [ragged_kernel_row(ragged[0]["gather_bags_ragged"], *ragged[1:])]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

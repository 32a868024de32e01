#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`embeddingtables_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card
    python3 chip_smoke.py --run-window-sweep   # only the run-scatter's L sweep
    python3 chip_smoke.py --per-table          # only the per-table comparison

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
    (indexer, and auto, which takes the dense method here) and bf16 tables
    with stochastic rounding; run-scatter launches counted per recipe, one
    step of each optimizer held against the plain versions, and per-step
    times with a kernel profile.
 8. Per-table training: 26 `SimpleEmbedding`s with the Criteo Kaggle
    cardinalities (capped at 250,000) through `lookup_vjp` and
    `ensemble_update`, counting `hot_accumulate` and run-scatter launches,
    with a kernel profile of one SGD and one AdaGrad step; then
    `hot_accumulate` checked and timed on the tiny features' own ids.
 9. A `kernels` JSON line (every hand kernel, its launches on its path and
    its times; the run-scatter's Zipf time beside its uniform one), the card
    line again, and the final JSON status line.

With `--run-window-sweep` it runs only phases 1-2 and the sweep that chose
the run-scatter's window length (`run_window_sweep`). With `--per-table` it
runs phases 1-2, `hot_accumulate`'s uniform times at S = 128 and 512, and
phase 8: the lines that compare two versions of the update kernels on the
per-table path. Copied into an unpacked older commit and run there, it
measures that commit's kernels the same way.

Without a card, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
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
                "hot_accumulate": "segsum_", "gather_rows": "gather_rows_kernel",
                "gather_bags": "gather_bags_kernel"}


def kernel_profile(fn, step_ms: float, reps: int = 5) -> dict:
    """Kernel time per call of `fn` by name (torch.profiler over `reps`
    calls), the hand kernels' share of it, and the device's idle share of a
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
                for name, key in HAND_KERNELS.items()},
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
                torch.cuda.synchronize()
                if adagrad:
                    rtol = 1e-6 if dtype == torch.float32 else 2 ** -7
                    torch.testing.assert_close(tk.float(), tp.float(),
                                               rtol=rtol, atol=1e-6)
                    torch.testing.assert_close(ak, ap, rtol=1e-6, atol=0.0)
                else:
                    require(torch.equal(bits(tk), bits(tp)),
                            f"scatter {kind} {dtype} not bitwise")
                e = max_abs_err(tk, tp)
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
                      None, scratch.data_ptr(), n, v, d, 0, -1e-4, 0.0,
                      _lib.stream_of(table))
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


def step_times(step, model, batches, generator=None, steps: int = 5) -> dict:
    """Per-step device time (CUDA events over back-to-back steps), host wall,
    examples/s, and the kernel profile of one step."""
    def run(i):
        b = batches[i % len(batches)]
        return step(model, b["dense"], b["cat"], b["label"],
                    generator=generator)
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
            "examples_per_s": B_TRAIN / (ms / 1e3),
            **kernel_profile(lambda: run(0), ms, reps=2)}


def stacked_training_phase(ett, S, H, G):
    t0 = time.perf_counter()
    cfg = ett.dlrm_small_config(vocab=VOCAB)
    batches = criteo_batches(ett, cfg.vocab_sizes, 4, SEED + 6)
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
         ett.SparseRowWiseAdaGrad(1e-3, stochastic_rounding=True), 0))
    launches = 0
    for name, rcfg, opt, per_step in recipes:
        r0 = time.perf_counter()
        model = ett.init_dlrm(rcfg, torch.Generator(device="cuda")
                              .manual_seed(SEED), device="cuda",
                              sparse_opt=opt)
        if name == "sgd":
            card_parity(ett, S, G, model, rcfg, batches[0])
        S.scatter_add_rows_sorted.launches = 0
        H.hot_accumulate.launches = 0
        res = ett.train_dlrm(rcfg, itertools.cycle(batches), steps,
                             sparse_opt=opt, dense_lr=dense_lr, model=model,
                             seed=SEED, log_every=1, verbose=False)
        counts = {"scatter_add_rows_sorted": S.scatter_add_rows_sorted.launches,
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
              **step_times(step, model, batches, gen),
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
    if "--per-table" in sys.argv[1:]:
        for segments in (128, 512):
            time_hot_accumulate(H, gen, segments)
        per_table_phase(ett, S, H, gen)
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
    scatter_launches = stacked_training_phase(ett, S, H, G)
    hot_launches = per_table_phase(ett, S, H, gen)

    csrc = "embeddingtables_tpu_torch/csrc/"
    pallas = "embeddingtables_tpu/ops/pallas/"
    paths = {
        "gather_rows": (serve_launches["gather_rows"], "gather.cu",
                        "gather.py:116"),
        "gather_bags": (bag_launches["gather_bags"], "gather.cu",
                        "gather.py:258"),
        "scatter_add_rows_sorted": (scatter_launches, "scatter.cu",
                                    "scatter.py:144"),
        "hot_accumulate": (hot_launches, "segsum.cu", "segsum.py:135")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": csrc + source,
         "replaces": pallas + where, "launches": launches,
         "max_abs_err": errs[name],
         "ms": timings[name]["kernel_ms"], "plain_ms": timings[name]["plain_ms"],
         "bound_ms": timings[name]["bound_ms"],
         "bound_by": timings[name]["bound_by"],
         "library_ms": timings[name]["library_ms"],
         **{k: timings[name][k] for k in ("zipf_ms", "zipf_bound_ms")
            if k in timings[name]}}
        for name, (launches, source, where) in paths.items()]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

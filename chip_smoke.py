#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`embeddingtables_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

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
 6. A `kernels` JSON line (every hand kernel, its launches on its path and
    its times), the card line again, and the final JSON status line.

Without a card, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
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

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step(model, dense, cat)
        torch.cuda.synchronize()
    # Kernel events only: an aten op's device time repeats its kernels'.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in kernels) / 5
    emit({"phase": "forward_time", "bag": bag, "batch": b,
          "forward_ms": ms, "host_wall_ms": wall,
          "examples_per_s": b / (ms / 1e3),
          "profiled_kernel_us_per_step": device_us,
          "device_idle_share": 1.0 - device_us / (ms * 1e3),
          "kernels_per_step": sum(e.count for e in kernels) / 5,
          "top_kernels_us_per_step": [
              [e.key[:70], e.self_device_time_total / 5]
              for e in kernels[:8]]})


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import embeddingtables_tpu_torch as ett
    from embeddingtables_tpu_torch.ops.cuda import _lib
    from embeddingtables_tpu_torch.ops.cuda import gather as G

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
    errs, timings = kernel_phase(G, gen)
    torch.cuda.empty_cache()

    cfg = ett.dlrm_small_config(vocab=250_000)
    t0 = time.perf_counter()
    model = ett.init_dlrm(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "table_bytes": model.tables.data.numel()
          * model.tables.data.element_size(),
          "table_shape": list(model.tables.data.shape),
          "compute_dtype": str(cfg.compute_dtype)})
    serve_launches = serving_phase(ett, G, model, cfg)
    throughput(ett, model, cfg)
    bag_launches, modelb, cfgb = multihot_phase(ett, G, model, cfg)
    throughput(ett, modelb, cfgb, bag=8)

    source = "embeddingtables_tpu_torch/csrc/gather.cu"
    paths = {"gather_rows": (serve_launches, "embeddingtables_tpu/ops/pallas/gather.py:116"),
             "gather_bags": (bag_launches, "embeddingtables_tpu/ops/pallas/gather.py:258")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": where,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timings[name]["kernel_ms"], "plain_ms": timings[name]["plain_ms"],
         "bound_ms": timings[name]["bound_ms"],
         "bound_by": timings[name]["bound_by"],
         "library_ms": timings[name]["library_ms"]}
        for name, (launches, where) in paths.items()]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of `BENCHMARK.json` once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Set-up (the process's start, imports, the
weights and traffic made from the seed, the program's first steps and the
warm-up of every shape the cell uses) is `setup_s`; then the cell's kind
(`kinds/<kind>.py`) measures for `--seconds`. With `--trace 0` the line
carries the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read by `metrics/<name>.py` from a profiled stretch of the window.
Once the window has closed and the program's state is freed, the plain
reference judges what the timed path produced (`correct`); each number
compared is printed beside its limit, last on standard error and last in
the line.

The run fails, and prints no result, without a CUDA card (or with fewer
than the cell asks for), without the port beside it, when a traced stretch
recorded no device operation, and when `jax`, `jaxlib`, `flax` or the JAX
package (`embeddingtables_tpu`, compared by whole top-level module name)
was loaded in this process by the time the window closed. Every build and
kernel cache goes under `build/` in the checkout.

A cell of several cards runs one process a card: this one is rank 0 and
starts the others (the same command with a rank and a localhost rendezvous
port), waits for each and ends any that outlive it; it fails if any rank
fails.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "embeddingtables_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda",
          "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def forbidden_modules(names) -> list:
    """The forbidden top-level packages among module `names`."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by rank 0 on the processes it starts for a cell of several cards
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float = T_START, rank: int = 0, port_no=None):
    """Set up, measure and check `cell` once on `device`; the result line
    as a dict. On a cell of several cards every rank calls this (`rank`,
    with the group's rendezvous `port_no`); rank 0 returns the line, the
    others None."""
    import torch
    from portbench import check, port, spec, trace

    seed = int(seed) % (1 << 63)
    kind = spec.load_module("kinds", cell.traffic["kind"])
    runner = kind.Runner(cell, seed, device, log, rank=rank, port_no=port_no)
    runner.setup()
    device = runner.device
    tracer = None
    if traced:
        tracer = trace.Tracer()
        tracer.warm()
        port.on_phase(tracer.phase_callback)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s}")
    w = runner.window(seconds, tracer)
    bad = forbidden_modules(sys.modules)
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    facts = w["facts"]
    kind_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu")
    facts.update(device_kind=kind_name, dim=cell.config["dim"])
    peak = int(facts["peak_bytes"])
    device_line = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": kind_name, "count": cell.chips,
                   "memory_peak_bytes": peak}
    metrics, line = {}, {}
    if traced:
        tr = facts["trace"]
        # busy and window seconds averaged over the cards of the cell
        both = port.all_reduce(torch.tensor(
            [trace.busy_ns(tr) / 1e9, tr.window_s], dtype=torch.float64,
            device=device)) / cell.chips
        for m in cell.per_layer:
            v = spec.load_module("metrics", m["name"]).read(facts)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_line.update(busy_s=float(both[0]), window_s=float(both[1]))
        line["breakdown"] = {"device_ops": trace.kernel_time_by_name(tr),
                             "idle_gaps": trace.idle_by_host(tr)}
    else:
        values = {"setup_s": setup_s, "peak_gb": peak / 1e9, **w["e2e"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    runner.release()
    if rank != 0:
        return None
    numbers = runner.numbers()
    for name, why in cell.not_compared.items():
        log(f"reading {name}: {numbers.pop(name)!r} (not compared: {why})")
    correct, rows = check.judge(numbers, cell.limits)
    for name, value, limit in rows:
        log(f"check {name}: {value!r} limit {limit!r}")
    return {"correct": correct, "attempted": w["attempted"],
            "failed": w["failed"], "metrics": metrics, "device": device_line,
            **line,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in rows}}


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(module: str, argv: list, world: int, port_no: int) -> list:
    """Ranks 1 .. world-1 of a cell on several cards, each a process of its
    own running `module` with `argv` and its rank; their standard error
    goes to a file in `TMPDIR`, shown only if the rank fails."""
    ranks = []
    for r in range(1, world):
        err = tempfile.TemporaryFile(mode="w+")
        ranks.append((subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--rank", str(r),
             "--port", str(port_no)], cwd=ROOT, stdout=subprocess.DEVNULL,
            stderr=err), err))
    return ranks


def stop_ranks(ranks: list, timeout: float) -> list:
    """Wait for every rank (killing what outlives `timeout`); their exit
    codes."""
    deadline = time.monotonic() + timeout
    rcs = []
    for proc, err in ranks:
        try:
            proc.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.returncode != 0:
            err.seek(0)
            log(f"rank exited with {proc.returncode}:\n{err.read()[-4000:]}")
        err.close()
        rcs.append(proc.returncode)
    return rcs


def _finite(x):
    """`x` with every non-finite float written as a string, so the line
    stays JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / sub)
    import torch
    from portbench import spec
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    import embeddingtables_tpu_torch  # noqa: F401 — the program must be here
    device = torch.device("cuda", 0)
    if args.rank:
        run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                 rank=args.rank, port_no=args.port)
        return 0
    ranks, port_no = [], None
    if cell.chips > 1:
        port_no = free_port()
        ranks = start_ranks("portbench.run", argv, cell.chips, port_no)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          device, port_no=port_no)
    finally:
        rcs = stop_ranks(ranks, timeout=120.0)
    if any(rcs):
        return 1
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

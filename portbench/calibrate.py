"""The readings the limits of `correct` are set from, on the card.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \
        [--control <k>] [--fault <name>]

For each seed, in one process: the cell's set-up (the program's first
steps), then the numbers `correct` compares for the program and, for the
first `--control` seeds, for the control (the plain reference in the next
precision below the configuration's, in the program's place) and the
faults planted in the reference. `--fault` plants a fault in the program
itself. One JSON line a seed, then the largest program reading and the
smallest control reading of each number. A cell of several cards runs a
process a card, as `portbench.run` does. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import sys


def _no_exchange():
    """The update's exchange between cards left out: each card applies
    only its own block's occurrences of the rows it holds
    (`parallel.sharded.owned_apply` without its all-gather)."""
    from embeddingtables_tpu_torch.parallel import dlrm, sharded
    full = sharded.owned_apply

    def local(*a, **kw):
        return full(*a, **dict(kw, batch_sharded=False))

    for mod in (sharded, dlrm):
        if hasattr(mod, "owned_apply"):
            mod.owned_apply = local


def _no_tower_allreduce():
    """The towers' gradient all-reduce left out: each card steps its copy
    of the towers by the gradient of its own block of the batch (the loss
    is still averaged over the cards)."""
    import torch.distributed as dist
    from embeddingtables_tpu_torch.parallel import dlrm

    def local_mean(ex, loss, grads):
        loss = loss.reshape(1).float()
        dist.all_reduce(loss, group=ex.data_group)
        return loss[0] / ex.n_data, grads

    dlrm._global_mean = local_mean


# Faults planted in the program, for the readings that bound a limit from
# above; `--fault` plants one in every rank.
FAULTS = {"no_exchange": _no_exchange,
          "no_tower_allreduce": _no_tower_allreduce}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", choices=sorted(FAULTS), default=None)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    import torch
    from portbench import run, spec
    if not torch.cuda.is_available():
        run.log("no CUDA card")
        return 3
    cell = spec.load_cell(args.workload, run.ROOT)
    kind = spec.load_module("kinds", cell.traffic["kind"])
    if args.fault:
        FAULTS[args.fault]()
    ranks, port_no = [], args.port
    if cell.chips > 1 and not args.rank:
        port_no = run.free_port()
        ranks = run.start_ranks("portbench.calibrate", argv, cell.chips,
                                port_no)
    program, control = {}, {}
    try:
        for i, seed in enumerate(args.seeds):
            # a group of several cards meets at a port of its own a seed
            runner = kind.Runner(cell, seed, torch.device("cuda", 0), run.log,
                                 rank=args.rank, port_no=None if port_no is
                                 None else port_no + i)
            runner.setup()
            runner.release()
            if args.rank:
                continue
            line = {"seed": seed, "program": runner.numbers()}
            if i < args.control:
                line["control"] = runner.control_numbers()
                if hasattr(runner, "fault_numbers"):
                    line["faults"] = runner.fault_numbers()
            print(json.dumps(line), flush=True)
            for k, v in line["program"].items():
                program[k] = max(program.get(k, v), v)
            for k, v in line.get("control", {}).items():
                control[k] = min(control.get(k, v), v)
            del runner
            torch.cuda.empty_cache()
    finally:
        rcs = run.stop_ranks(ranks, timeout=300.0)
    if not args.rank:
        print(json.dumps({"workload": args.workload,
                          "seeds": len(args.seeds), "program_max": program,
                          "control_min": control}))
    return 1 if any(rcs) else 0


if __name__ == "__main__":
    sys.exit(main())

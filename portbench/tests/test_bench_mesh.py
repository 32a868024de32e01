"""The four-card cell's path rehearsed on the CPU: four processes on a gloo
group run a shrunk `dlrm.train.full4` (the sharded DLRM through
`train_dlrm(mesh=...)`), rank 0 judges it against the plain reference;
with the update's exchange between cards left out, or the towers' gradient
all-reduce, `correct` comes out false."""
import multiprocessing

import pytest
import torch

from portbench import calibrate, run
from portbench.tests import tiny

WORLD = 4


def _rank(rank, port_no, fault, out):
    if fault:
        calibrate.FAULTS[fault]()
    c = tiny.cell("dlrm.train.full4")
    res = run.run_cell(c, 2**31 + 21, 0.5, False, torch.device("cpu"),
                       rank=rank, port_no=port_no)
    if rank == 0:
        out.put(res)


def _run(fault) -> dict:
    ctx = multiprocessing.get_context("spawn")
    out, port_no = ctx.Queue(), run.free_port()
    procs = [ctx.Process(target=_rank, args=(r, port_no, fault, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        res = out.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return res


@pytest.mark.parametrize("fault", [None, "no_exchange", "no_tower_allreduce"],
                         ids=["sound", "no_exchange", "no_tower_allreduce"])
def test_four_ranks_on_gloo(fault):
    res = _run(fault)
    assert res["correct"] is (fault is None)
    assert res["attempted"] > 0 and res["device"]["count"] == WORLD
    gap = res["checks"]["replica_gap"]["value"]
    assert (gap > 0) is (fault == "no_tower_allreduce")

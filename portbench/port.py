"""What the benchmark takes from the program: its optimizers as a
configuration names them, its telemetry phases, its hand kernels' names as
the profiler shows them, and its process group and mesh for a cell on
several cards. Everything else the port does is the system under test,
driven through `families/<family>.py`."""
from __future__ import annotations

# Substrings of the port's hand kernels' device-function names
# (`embeddingtables_tpu_torch/csrc/*.cu`).
HAND_KERNELS = {"gather_rows": "gather_rows_", "gather_bags": "gather_bags_",
                "run_scatter": "runscatter_", "segsum": "segsum_"}


def hand_kernel(name: str):
    """The hand kernel a device-function name belongs to, or None."""
    for kernel, key in HAND_KERNELS.items():
        if key in name:
            return kernel
    return None


def sparse_optimizer(spec: dict):
    """The port's sparse optimizer for a configuration's
    `sparse_optimizer` entry."""
    from embeddingtables_tpu_torch.optim import (SparseRowWiseAdaGrad,
                                                 SparseSGD)
    if spec["name"] == "sgd":
        return SparseSGD(lr=float(spec["lr"]))
    if spec["name"] == "rowwise_adagrad":
        return SparseRowWiseAdaGrad(lr=float(spec["lr"]),
                                    eps=float(spec["eps"]),
                                    method=spec.get("method", "auto"))
    raise ValueError(f"unknown sparse optimizer {spec['name']!r}")


def telemetry_phases() -> dict:
    """{phase: (count, total_s)} of the port's telemetry now."""
    from embeddingtables_tpu_torch.utils.telemetry import get_telemetry
    return {k: (v.count, v.total_s)
            for k, v in get_telemetry().phases.items()}


def on_phase(cb) -> None:
    """Register `cb(name, "start" | "end")` on the port's telemetry."""
    from embeddingtables_tpu_torch.utils.telemetry import get_telemetry
    get_telemetry().on_phase(cb)


def init_mesh(world: int, rank: int, port: int, device):
    """Join the `world` ranks' group over localhost as `rank` (NCCL on a
    card, gloo on the CPU) and make their one-axis mesh; (device, mesh)."""
    import datetime
    from embeddingtables_tpu_torch.parallel.mesh import (init_process,
                                                         local_mesh)
    dev = init_process(f"tcp://127.0.0.1:{port}", world, rank,
                       device=device, local_size=world,
                       timeout=datetime.timedelta(seconds=300))
    return dev, local_mesh(world, device=dev)


def all_reduce(t, op: str = "sum"):
    """`t` reduced over the group in place (nothing without one)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX,
                               "min": dist.ReduceOp.MIN}[op])
    return t


def leave_mesh() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()

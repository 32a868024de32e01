"""Device ms a sharded step spends in kernels that are neither the port's
hand kernels nor NCCL's (cuBLAS and aten), rank 0."""
from portbench import readings


def read(facts: dict):
    return readings.per_traced_step_ms(facts, hand=False)

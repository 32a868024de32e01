"""Device ms a training step spends in kernels that are not the port's hand
kernels (cuBLAS GEMMs, aten's elementwise, sort and reduction kernels):
their summed durations in the traced call over its steps."""
from portbench import readings


def read(facts: dict):
    return readings.per_traced_step_ms(facts, hand=False)

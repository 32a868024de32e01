"""Device ms a training step spends in the port's hand kernels
(`gather_rows_`, `gather_bags_`, `runscatter_`, `segsum_`): their summed
durations in the traced call over its steps."""
from portbench import readings


def read(facts: dict):
    return readings.per_traced_step_ms(facts, hand=True)

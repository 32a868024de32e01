"""Device ms a training step spends in "update.scatter"
(`scatter_add_rows_sorted`: the run-scatter, with row-wise AdaGrad's
epilogue where it applies), over the traced call's steps."""
from portbench import spans


def read(facts: dict):
    return spans.self_ms(facts, "update.scatter")

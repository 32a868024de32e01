"""Device operations (kernels, copies, sets) a traced training step
enqueues on the step's stream inside "step" (`spans.launches`): the
dispatch layer's count of work."""
from portbench import spans


def read(facts: dict):
    return spans.launches(facts)

"""Host ms a traced training step spends in the telemetry phase "step"
less the time its launching threads wait on the device or on a full
launch queue (`spans.enqueue_ms`): the host's own dispatch cost, which
`dispatch_ms.train` cannot show where the queue is full."""
from portbench import spans


def read(facts: dict):
    return spans.enqueue_ms(facts)

"""Device ms a training step spends in operations enqueued inside
"step.backward" (`torch.autograd.grad`, launched from autograd's thread
while the loop's thread is in the span), over the traced call's steps."""
from portbench import spans


def read(facts: dict):
    return spans.self_ms(facts, "step.backward")

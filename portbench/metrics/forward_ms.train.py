"""Device ms a training step spends in operations enqueued inside
"step.forward" (towers or cross layers, interaction, loss), over the
traced call's steps (`spans.self_ms`)."""
from portbench import spans


def read(facts: dict):
    return spans.self_ms(facts, "step.forward")

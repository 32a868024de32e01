"""The training step's share of the card's bf16 peak
(`readings.step_mfu`: the model's FLOPs from the configuration's shapes,
3 x the forward's, over CUDA-event time of the window's untraced calls)."""
from portbench import readings


def read(facts: dict):
    return readings.step_mfu(facts)

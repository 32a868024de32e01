"""Id slots the training step's lookup gathers a step, pads included: the
port's telemetry counter `lookup.ids` over the window's steps (a multi-hot
step at B = 65,536 reads 14,024,704 jagged, 170,393,600 padded to the
widest bag). None where the program has no such counter."""


def read(facts: dict):
    return facts.get("counters", {}).get("lookup.ids")

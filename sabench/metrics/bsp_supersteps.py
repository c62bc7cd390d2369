"""BSPCounters.supersteps per build of the window: the paper's S."""


def read(record):
    steps = record.get("supersteps")
    if not steps:
        return None
    return sum(steps) / len(steps)

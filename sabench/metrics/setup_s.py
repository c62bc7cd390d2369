"""Seconds from the process's start to the window's: imports, the card,
the inputs made from the seed, the kernels' build or load, the warm-up."""


def read(record):
    return record["setup_s"]

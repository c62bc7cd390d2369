"""Stride-doubling rounds of the sparse construction that found ties, per
build of the window: the program's ``repro_torch.sparse.rounds`` counter
(0 where it kept counters and no round found ties). None where the
program keeps no counters."""

COUNTER = "repro_torch.sparse.rounds"


def read(record):
    per_build = record.get("counters_per_build")
    if per_build is None:
        return None
    return per_build.get(COUNTER, 0.0)

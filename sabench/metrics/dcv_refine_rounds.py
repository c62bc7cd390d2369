"""Refinement rounds of the DC-v recursion's tie resolution, per build of
the window: the program's ``repro_torch.dcv.refine_rounds`` counter (0
where it counts DC-v levels and no round ran). None where the program
keeps no counters, or none of the DC-v recursion."""

COUNTER = "repro_torch.dcv.refine_rounds"
LEVELS = "repro_torch.dcv.levels"


def read(record):
    per_build = record.get("counters_per_build")
    if not per_build or LEVELS not in per_build:
        return None
    return per_build.get(COUNTER, 0.0)

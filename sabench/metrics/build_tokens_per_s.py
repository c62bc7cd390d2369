"""Data tokens of every whole build in the window, separators excluded,
over the time from the window's start to the end of its last build."""
from sabench.stats import rate_over_builds


def read(record):
    if record.get("kind") != "build":
        return None
    return rate_over_builds(record["builds"], record["t_start"])

"""Device kernels the profiler saw in the traced window, per build."""


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "build" or not trace or not trace["units"] \
            or not trace["kernels"]:
        return None
    return trace["kernels"] / trace["units"]

"""The union of device intervals in the traced window, in ms, per build
traced."""


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "build" or not trace or not trace["units"] \
            or not trace["busy_s"]:
        return None
    return 1e3 * trace["busy_s"] / trace["units"]

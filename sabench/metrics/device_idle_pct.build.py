"""100 x (1 - the union of device intervals / the traced window) over a
traced window of whole builds."""


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "build" or not trace or not trace["busy_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])

"""The union of device intervals launched under the program's
``repro_torch.sparse.construct`` span (the sparse suffix array's head sort
and stride doubling), in ms, per build traced. None where the trace holds
no device time or no such span."""

SPAN = "repro_torch.sparse.construct"


def read(record):
    trace, table = record.get("trace"), record.get("span_table")
    if record.get("kind") != "build" or not trace or not trace["units"] \
            or not trace["busy_s"] or not table:
        return None
    row = table["spans"].get(SPAN)
    if row is None:
        return None
    return 1e3 * row["device_s"] / trace["units"]

"""Host calls of cudaStreamSynchronize, cudaDeviceSynchronize and
cudaEventSynchronize in the traced window, less the benchmark's one a
build, per build."""


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "build" or not trace or not trace["units"] \
            or not trace["kernels"]:
        return None
    return trace["syncs"] / trace["units"]

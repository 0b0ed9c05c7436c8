"""The device's idle share of the traced slice: 100 * (1 - busy / window),
busy the union of the kernel, memcpy and memset intervals."""


def idle_share(run, request):
    if run.trace is None or run.request != request or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

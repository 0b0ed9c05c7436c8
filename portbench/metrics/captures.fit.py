"""captures.fit: program captures (`jit.traces`) during the window; the
set-up warmed every shape, so 0 is expected. Layer: program funnel. Fit
cells."""


def read(run):
    if run.request != "fit":
        return None
    return run.counters["counters"].get("jit.traces", 0)

"""readback_wait_ms.fit: the program's `readback.wait` phase a fit (the
host's wait for the fit's queued work before its result is copied),
over the window. Layer: SGD engine. Fit cells."""

from portbench.metrics._phase import per_request


def read(run):
    return per_request(run, "fit", "readback.wait")

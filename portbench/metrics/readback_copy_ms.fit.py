"""readback_copy_ms.fit: the program's `readback.copy` phase a fit (the
result's copy to the host, its split and per-tensor copies), over the
window. Layer: SGD engine. Fit cells."""

from portbench.metrics._phase import per_request


def read(run):
    return per_request(run, "fit", "readback.copy")

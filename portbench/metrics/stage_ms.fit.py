"""stage_ms.fit: the program's `sgd.stage` phase a fit (the training
inputs staged, the initial coefficient cast and uploaded), over the
window. Layer: SGD engine. Fit cells."""

from portbench.metrics._phase import per_request


def read(run):
    return per_request(run, "fit", "sgd.stage")

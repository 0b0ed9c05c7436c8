"""estimator_ms.fit: the self time of the program's `stage.fit` phase a
fit: `stage.fit` less its children `sgd.stage`, `iteration.dispatch`,
`readback.wait` and `readback.copy` (the estimator's own Python: params,
columns, the initial coefficient, the unpack, the model), over the
window. Not clamped: a negative reading shows children timed outside
their parent. Layer: Estimator/Model API. Fit cells."""

from portbench.metrics._phase import per_request

CHILDREN = ("sgd.stage", "iteration.dispatch", "readback.wait", "readback.copy")


def read(run):
    whole = per_request(run, "fit", "stage.fit")
    children = per_request(run, "fit", *CHILDREN)
    if whole is None or children is None:
        return None
    return whole - children

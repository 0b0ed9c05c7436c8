"""host_syncs.score: blocking host-device synchronisations the program
accounts (`iteration.host_sync`) a transform, over the window. Layer:
Estimator/Model API. Transform cells."""


def read(run):
    if run.request != "transform" or not run.window.completed:
        return None
    return run.counters["counters"].get("iteration.host_sync", 0) / run.window.completed

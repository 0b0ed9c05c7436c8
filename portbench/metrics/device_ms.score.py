"""device_ms.score: the card's time on a transform's kernels, from the
CUDA-event pairs the program records around a sample of the transform
kernels (`transform.device`), over their count in the window. Layer:
Estimator/Model API. Transform cells."""

from portbench.metrics._phase import per_sample


def read(run):
    return per_sample(run, "transform", "transform.device")

"""device_ms.fit: the card's time on a fit's captured graph, from the
CUDA-event pairs the program records around a sample of the replays
(`replay.device`), over their count in the window. Layer: SGD engine.
Fit cells."""

from portbench.metrics._phase import per_sample


def read(run):
    return per_sample(run, "fit", "replay.device")

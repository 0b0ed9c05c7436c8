"""idle_share.score: the card's idle share of the traced slice of a
transform cell. Layer: device."""

from portbench.metrics._idle import idle_share


def read(run):
    return idle_share(run, "transform")

"""idle_share.fit: the card's idle share of the traced slice of a fit
cell. Layer: device."""

from portbench.metrics._idle import idle_share


def read(run):
    return idle_share(run, "fit")

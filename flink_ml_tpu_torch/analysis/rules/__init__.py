"""The port's tpulint rules. Importing this package registers every rule
with the engine's registry (flink_ml_tpu_torch.analysis.engine)."""

from . import (  # noqa: F401
    accounting,
    channelprotocol,
    coverage,
    flowcontrol,
    hostsync,
    lockorder,
    memledger,
    residentprogram,
    retrace,
    servepath,
    snapshotcommit,
    untimedwait,
)

"""The device's idle time ahead of the training step's optimizer ops.

The gaps in which the device waited for an op launched inside the
program's ``train.optimizer`` spans, as % of the traced full pass's op
extent (``harness/idle.py``). That pass also records every host op,
which slows the host: compare the reading from change to change, not with
``device_idle.train``, which the device-only pass gives.
Source: the device trace. None when the trace holds no such op.
"""
from harness.idle import idle_share


def read(ctx):
    return idle_share(ctx.digest, "train.optimizer")

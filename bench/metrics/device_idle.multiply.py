"""The share of the traced window in which no op ran on the device.
Source: the device trace."""


def read(ctx):
    dg = ctx.digest
    return None if dg.window_s <= 0 or dg.busy_s <= 0 else 100.0 * (1.0 - dg.busy_s / dg.window_s)

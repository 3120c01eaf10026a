"""device_idle_pct.pick: 100 x (1 - the union of kernel and copy
intervals / the traced window) in a pick cell."""

from portbench.trace import idle_pct


def read(ctx):
    return idle_pct(ctx, "pick")

"""device_idle_pct.screen: the share of the traced slice's wall time in which no
operation ran on the card (torch.profiler's device events, their union)."""
from benchlib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "screen")

"""screen_pairs_per_s: real pairs whose records the entry returned in the
window, over the window's seconds (host clock)."""
from benchlib.readers import rate


def read(ctx):
    return rate(ctx, "screen")

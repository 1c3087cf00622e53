"""train_pairs_per_s: real training pairs whose optimizer steps the window
completed (whole epochs: train pass and val pass), over the window's
seconds (host clock)."""
from benchlib.readers import rate


def read(ctx):
    return rate(ctx, "train")

"""loader_ms_per_batch.screen: the benchmark's own span around the
BucketedLoader iterator's next batch (host padding and stacking), mean
over the window's batches (host clock)."""
from benchlib.readers import mean_ms


def read(ctx):
    return mean_ms(ctx, "loader_s")

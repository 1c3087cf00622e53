"""loader_work_ms_per_batch.screen: the mean of the window's ``loader.batch``
spans, BucketedLoader's assembly of one batch (padding and stacking), as
the program times it. Program spans (host clock)."""
from benchlib import spans


def read(ctx):
    return spans.mean_ms(spans.records(ctx, "screen"), "loader.batch")

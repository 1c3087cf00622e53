"""screen_batch_p95_ms: the 95th percentile, over every batch of the
window, of the time from the batch's hand-over to the entry to its records
being on the host (host clock)."""
from benchlib.readers import percentile_ms


def read(ctx):
    return percentile_ms(ctx, "batch_s", 95.0)

"""host_gap_ms_per_batch.screen: the mean, over the window's batches, of the
time from one batch's ``inference.fetch`` span's end (its outputs on the
host) to the next batch's ``inference.forward`` span's start (its copy to
the card): host work between batches (records, the loader, the request's
packing) while the card has nothing queued. Program spans (host clock).

A traced run starts the profiler before handing the window's batch
``trace.from_batch`` (0: the first) and stops it, reading its buffers for
seconds, after batch ``from_batch + batches - 1``: the gaps before batches
``from_batch`` to ``from_batch + batches`` hold the benchmark's profiler,
not the program, and are left out there."""
from benchlib import spans


def read(ctx):
    skip = ()
    if ctx.traced:
        t = ctx.cell.mix["trace"]
        skip = range(t["from_batch"], t["from_batch"] + t["batches"] + 1)
    return spans.gaps_ms(spans.records(ctx, "screen"), "inference.fetch", "inference.forward",
                         skip)

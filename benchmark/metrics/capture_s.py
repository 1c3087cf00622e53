"""capture_s: the seconds of set-up's ``graph.warmup`` spans (eager work
before a capture: a bucket's warm-up steps, a served forward's and an
explainer loop's first batch) and ``graph.capture`` spans (one capture of
every variant), those that end before the window starts. Program spans
(host clock)."""
from benchlib import spans


def read(ctx):
    return spans.total_s(spans.records(ctx, setup=True), ("graph.warmup", "graph.capture"))

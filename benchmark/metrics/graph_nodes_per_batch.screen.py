"""graph_nodes_per_batch.screen: the device operations (kernel, memcpy and
memset nodes, counted on each graph at its capture) of the window's
replayed forwards and explainer loops (the values of its
``inference.forward`` and ``inference.explain`` spans), over its batches
(its ``inference.forward`` spans). Program counter."""
from benchlib import spans


def read(ctx):
    return spans.values_per(spans.records(ctx, "screen"),
                            ("inference.forward", "inference.explain"), "inference.forward")

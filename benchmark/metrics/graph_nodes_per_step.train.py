"""graph_nodes_per_step.train: the mean device operations (kernel, memcpy
and memset nodes, counted on each graph at its capture) of the window's
replayed train steps (the values of its ``train.replay`` spans). Program
counter."""
from benchlib import spans


def read(ctx):
    return spans.values_per(spans.records(ctx, "train"), ("train.replay",), "train.replay")

"""segment_roofline.train: the bytes the slice's segment operations need (K1
sorted segment-sum, K2 gather, K3 scatter-add, forward and backward; inputs
read once, outputs written once, from the op layer's call shapes while each
graph was captured) at 3.35 TB/s, over the device time of the kernels named
in segment_kernels.txt."""
from benchlib.readers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "train", "segment_kernels.txt")

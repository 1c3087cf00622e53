"""mfu.train: the matrix-product operations of the traced slice's train
steps (the plain reference's forward and backward at each bucket's padded
shapes, counted on the meta device) over the slice's seconds x 989 TF/s
(bf16 dense, NVIDIA H100 SXM)."""
from benchlib.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train")

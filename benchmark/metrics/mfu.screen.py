"""mfu.screen: the matrix-product operations of the traced slice's batches
(the plain reference's forward, plus the explainer's steps where it is on,
at each bucket's padded shapes, counted on the meta device) over the
slice's seconds x 67 TF/s (f32, TF32 off, NVIDIA H100 SXM)."""
from benchlib.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "screen")

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, at the card's full 700 W): the denominators of every roofline and
MFU share the benchmark reports. A run prints the card's power limit
beside them where it reads one."""
PEAKS = {
    "bfloat16": 989e12,     # FLOP/s, tensor cores
    "tfloat32": 494.7e12,   # FLOP/s, f32 products on the tensor cores (TF32 on)
    "float32": 67e12,       # FLOP/s, IEEE f32 outside the tensor cores (TF32 off)
    "hbm_bytes_per_s": 3.35e12,
}


def peak_key(dtype) -> str:
    """The PEAKS entry of the matrix products a model runs in ``dtype`` (a
    torch dtype), with the card's TF32 switch as it stands."""
    import torch

    name = str(dtype).rsplit(".", 1)[-1]
    if name == "float32" and torch.backends.cuda.matmul.allow_tf32:
        return "tfloat32"
    if name not in PEAKS:
        raise ValueError(f"no peak for {name}")
    return name

"""The chip's published peaks, against which every roofline and MFU share
is stated (NVIDIA H100 SXM data sheet, dense, at the full 700 W limit).

A float32 operation counts at the CUDA-core rate unless it runs in TF32;
``peak_flops`` takes the precision a part of the chain states.
"""

HBM_BYTES_PER_S = 3.35e12

FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
}

BYTES = {"bfloat16": 2, "float16": 2, "tf32": 4, "float32": 4}


def peak_flops(dtype: str) -> float:
    return FLOPS[dtype]


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take for work of ``flops`` operations
    in ``dtype`` that reads and writes ``nbytes``: the larger of the two
    bounds."""
    return max(flops / peak_flops(dtype), nbytes / HBM_BYTES_PER_S)

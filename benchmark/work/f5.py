"""Operations of F5-TTS's DiT (``pipeline.dit`` of an F5 configuration)
from its shapes, 2 operations a multiply-add. Elementwise work (norms,
RoPE, gates, Mish, residuals) is not counted, so a share of a peak built
on these counts is a lower bound.

A guided step runs the block stack over 2B rows (conditional and
unconditional) of N frames. Per step, in the blocks' precision: q, k, v
and the output projection, the attention products, the feed-forward, the
two grouped convs of the position embedding and the output projection;
in fp32: the x columns of the input projection (once over B rows), the
time MLP and every block's modulation (B rows). Per request, in fp32: the
text embedding's ConvNeXt-V2 blocks (2B rows) and the cond and text
columns of the input projection.
"""

from . import attention


def total_frames(pipe: dict) -> int:
    """F5's fix_duration in mel frames: int(seconds * sr / hop)."""
    v = pipe["vocoder"]
    return int(pipe["sampler"]["fix_duration"] * v["sampling_rate"]
               / v["hop_size"])


def step_flops(dit: dict, b: int, n: int):
    """(block flops, other flops) of one guided step at batch b and n
    frames."""
    d, depth, nh, hd = dit["dim"], dit["depth"], dit["heads"], \
        dit["dim_head"]
    inner = nh * hd
    rows = 2 * b
    tok = rows * n
    per_layer = 2.0 * tok * d * 3 * inner + 2.0 * tok * inner * d
    per_layer += attention.call(rows, nh, n, n, hd, "float32")[0]
    per_layer += 2 * 2.0 * tok * d * dit["ff_mult"] * d
    k, g = dit["conv_pos_kernel"], dit["conv_pos_groups"]
    blocks = depth * per_layer + 2 * 2.0 * tok * d * (d // g) * k \
        + 2.0 * tok * d * dit["mel_dim"]
    tf = dit["time_freq_dim"]
    other = 2.0 * b * n * dit["mel_dim"] * d
    other += 2.0 * b * (tf * d + d * d) + 2.0 * b * d * 6 * d * depth \
        + 2.0 * b * d * 2 * d
    return blocks, other


def request_flops(dit: dict, b: int, n: int) -> float:
    """The text embedding and the static columns of the input projection,
    once per request."""
    td, rows = dit["text_dim"], 2 * b
    tok = rows * n
    per_layer = 2.0 * tok * td * 7 + 2 * 2.0 * tok * td * dit["conv_mult"] * td
    return dit["conv_layers"] * per_layer + \
        2.0 * tok * (dit["mel_dim"] + td) * dit["dim"]


def attention_calls(dit: dict, b: int, n: int):
    """[(flops, bytes)] of one guided step's attention calls, one a block
    over 2B rows, at the compute dtype."""
    return [attention.call(2 * b, dit["heads"], n, n, dit["dim_head"],
                           dit["compute_dtype"])] * dit["depth"]

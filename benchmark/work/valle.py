"""Operations and bytes of a VALL-E request (``pipeline.model`` of a VALL-E
configuration) from its shapes, 2 operations a multiply-add. Elementwise
work (norms, PE, residuals, the draw) is not counted, so a share of a peak
built on these counts is a lower bound.

A request of b rows, t phonemes, a prompt of p frames and n generated
frames: the AR prefill over t + p - 1 positions (the prompt's last frame
is the first decode step's input), n decode steps of one position a row
over t + p - 1 + i + 1 keys, and 7 NAR stages over t + p + n positions,
each a full forward; the heads (AR 1025, NAR 1024 outputs) in fp32.
"""

from . import attention
from .peaks import BYTES


def _dense(model: dict, tokens: int) -> float:
    """A layer's in- and out-projections and feed-forward."""
    d, f = model["d_model"], model["ffn_dim"]
    return 2.0 * tokens * (4 * d * d + 2 * d * f)


def _heads(model: dict) -> tuple:
    return model["nhead"], model["d_model"] // model["nhead"]


def prefill_call(model: dict, b: int, t: int, pa: int):
    """(flops, bytes) of one prefill attention call: the visible pairs of
    the prefix-causal mask (t^2 for the text rows, t + i + 1 for audio row
    i), Q, K, V and O once."""
    h, hd = _heads(model)
    s = t + pa
    pairs = t * t + pa * t + pa * (pa + 1) // 2
    return (4.0 * b * h * pairs * hd,
            BYTES[model["compute_dtype"]] * b * h * hd * 4 * s)


def decode_call(model: dict, b: int, kv: int):
    """(flops, bytes) of one decode call over ``kv`` cached keys: the cache's
    K and V rows read, q read and o written."""
    h, hd = _heads(model)
    return (4.0 * b * h * kv * hd,
            BYTES[model["compute_dtype"]] * b * h * hd * (2 * kv + 2))


def attention_calls(model: dict, b: int, t: int, p: int, n: int):
    """[(flops, bytes)] of a request's kernel-A calls: the prefill's, one a
    layer, and every NAR stage's, one a layer, unmasked."""
    h, hd = _heads(model)
    layers, stages = model["num_layers"], model["num_codebooks"] - 1
    full = attention.call(b, h, t + p + n, t + p + n, hd,
                          model["compute_dtype"])
    return [prefill_call(model, b, t, p - 1)] * layers \
        + [full] * (layers * stages)


def decode_calls(model: dict, b: int, t: int, p: int, n: int):
    """[(flops, bytes)] of a request's decode launches, one a layer a
    step."""
    return [decode_call(model, b, t + p + i) for i in range(n)
            for _ in range(model["num_layers"])]


def flops(model: dict, b: int, t: int, p: int, n: int):
    """(block flops, other flops) of a request: the layers' products and
    attention in the blocks' precision, the heads and AdaLN projections in
    fp32."""
    layers, stages = model["num_layers"], model["num_codebooks"] - 1
    d, v = model["d_model"], model["codebook_size"]
    blocks = layers * (_dense(model, b * (t + p - 1)) + _dense(model, b * n)
                       + stages * _dense(model, b * (t + p + n)))
    blocks += sum(fl for fl, _ in attention_calls(model, b, t, p, n))
    blocks += sum(fl for fl, _ in decode_calls(model, b, t, p, n))
    other = 2.0 * b * n * d * (v + 1) + stages * 2.0 * b * n * d * v \
        + stages * (2 * layers + 1) * 2.0 * d * 2 * d
    return blocks, other

"""Operations of the EnCodec codec (``pipeline.codec``), the mel analysis
and the VQ lookups of the chain, from their shapes: convolutions, the
LSTM's products and the codebook distances, 2 operations a multiply-add.
"""

import math


def frames(codec: dict, samples: int) -> int:
    """Latent frames of a waveform of ``samples`` (the strided convs pad
    the last frame whole)."""
    hop = math.prod(codec["ratios"])
    return -(-samples // hop)


def _conv(b, t_out, cin, cout, k):
    return 2.0 * b * t_out * cin * cout * k


def _lstm(codec, b, t, size):
    return codec["lstm_layers"] * 2.0 * b * t * 4 * size * 2 * size


def _resblock(codec, b, t, dim):
    hid = dim // codec["compress"]
    return (_conv(b, t, dim, hid, codec["residual_kernel_size"])
            + _conv(b, t, hid, dim, 1) + _conv(b, t, dim, dim, 1)
            ) * codec["num_residual_layers"]


def encode_flops(codec: dict, b: int, samples: int, nq: int = 2) -> float:
    """SEANet encoder, LSTM and the RVQ's nearest-code products."""
    ch, t = codec["num_filters"], samples
    total = _conv(b, t, codec["channels"], ch, codec["kernel_size"])
    for r in reversed(codec["ratios"]):
        total += _resblock(codec, b, t, ch)
        t = -(-t // r)
        total += _conv(b, t, ch, 2 * ch, 2 * r)
        ch *= 2
    total += _lstm(codec, b, t, ch)
    total += _conv(b, t, ch, codec["dimension"], codec["last_kernel_size"])
    total += nq * 2.0 * b * t * codec["dimension"] * codec["codebook_size"]
    return total


def decode_flops(codec: dict, b: int, t: int) -> float:
    """SEANet decoder from t frames: convs, LSTM, transposed convs."""
    ch = codec["num_filters"] * 2 ** len(codec["ratios"])
    total = _conv(b, t, codec["dimension"], ch, codec["kernel_size"])
    total += _lstm(codec, b, t, ch)
    for r in codec["ratios"]:
        total += 2.0 * b * t * ch * (ch // 2) * 2 * r     # transposed conv
        t *= r
        ch //= 2
        total += _resblock(codec, b, t, ch)
    total += _conv(b, t, ch, codec["channels"], codec["last_kernel_size"])
    return total


def vq_flops(b: int, t: int, hidden: int, codebook: int,
             channels: int = 2) -> float:
    """The VQ's distances of [b, channels, t, hidden] latents to the
    codebook."""
    return 2.0 * b * channels * t * hidden * codebook


def mel_frames(voc: dict, samples: int) -> int:
    pad = (voc["n_fft"] - voc["hop_size"]) // 2
    return (samples + 2 * pad - voc["n_fft"]) // voc["hop_size"] + 1


def mel_flops(voc: dict, b: int, samples: int) -> float:
    """The framed DFT (cosine and sine) and the mel filterbank."""
    f = mel_frames(voc, samples)
    nf = voc["n_fft"] // 2 + 1
    return 2 * 2.0 * b * f * voc["n_fft"] * nf + 2.0 * b * f * nf * \
        voc["num_mels"]

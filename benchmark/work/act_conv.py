"""Operations and bytes of the AMP blocks' fused anti-aliased SnakeBeta ->
conv pairs, from the configuration's shapes.

Which pairs: those of the stages whose width lies in the band that the
configuration's ``aa_impl="fused_conv"`` under ``layout="nlc"`` and
``conv_impl="pallas"`` fuses (96 to 384 channels, in the stages before
the first one narrower than 96). A pair reads its input, the activation's
two per-channel coefficients, the conv's weights and bias once, and
writes its output once; it does 2 C O K T operations of convolution and
56 a channel-sample of activation (two 6-tap upsample phases, SnakeBeta
on each, a 12-tap decimation).
"""

from . import vocoder
from .peaks import BYTES

FUSED_BAND = (96, 384)
NARROW = 96
ACT_OPS_PER_SAMPLE = 56.0


def fused_stage_widths(voc: dict, mel_frames: int):
    """[(width, samples)] of the stages whose pairs are fused."""
    if not (voc["aa_impl"] == "fused_conv" and voc["layout"] == "nlc"
            and voc["use_anti_aliasing"]):
        return []
    out = []
    for w, t in vocoder.stages(voc, mel_frames):
        if voc["conv_impl"] == "pallas" and w < NARROW:
            break
        if FUSED_BAND[0] <= w <= FUSED_BAND[1]:
            out.append((w, t))
    return out


def calls(voc: dict, b: int, mel_frames: int):
    """[(flops, bytes)] of every fused pair of one vocoder forward."""
    dt = voc["compute_dtype"]
    e = BYTES[dt]
    out = []
    for w, t in fused_stage_widths(voc, mel_frames):
        for rk, dils in zip(voc["resblock_kernel_sizes"],
                            voc["resblock_dilation_sizes"]):
            for _ in range(2 * len(dils)):
                fl = 2.0 * b * w * w * rk * t + ACT_OPS_PER_SAMPLE * b * w * t
                nb = e * (2 * b * w * t + w * w * rk) + 4 * (3 * w)
                out.append((fl, nb))
    return out

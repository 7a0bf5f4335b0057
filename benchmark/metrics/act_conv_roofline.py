"""act_conv_roofline: the fused anti-aliased SnakeBeta -> conv pairs'
share of their roofline (``_roofline``, ``benchmark/work/act_conv``)."""

from ._roofline import share

NAMES = ("act_conv",)


def read(run):
    return share(run, "act_conv", NAMES)

"""attention_roofline: the attention calls' share of their roofline
(``_roofline``); the kernels are those whose names say attention."""

from ._roofline import share

NAMES = ("attn", "attention", "flash", "fmha")


def read(run):
    return share(run, "attention", NAMES)

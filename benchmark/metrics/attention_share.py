"""attention_share: of the device time of the operations launched inside
each request's ``sampler`` span, the share taken by the attention kernels
(names as ``attention_roofline`` reads them), over the traced requests,
in % (``_spans``, phase (b)); nothing where no span or operation was
traced."""

from ._spans import _named_ops, phases
from .attention_roofline import NAMES


def read(run):
    p = phases(run)
    if not p:
        return None
    total = attn = 0
    for ops in _named_ops(p, "sampler"):
        for name, s, e in ops:
            total += e - s
            if any(k in name.lower() for k in NAMES):
                attn += e - s
    return 100.0 * attn / total if total > 0 else None

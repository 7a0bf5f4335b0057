"""kv_attention_roofline: the decode launch's share of its roofline
(``_roofline``): the least time of the decode calls' work (by their bytes:
the cache's K and V rows, q and o; ``benchmark/work/valle.py``) over the
device time of the kernels named ``kv_decode``; nothing where no such
kernel ran."""

from ._roofline import share

NAMES = ("kv_decode",)


def read(run):
    return share(run, "kv_attention", NAMES)

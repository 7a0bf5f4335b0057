"""text_encode_ms: the mean host duration of the program's
``text_encode`` span (F5's text embedding and ConvNeXt-V2 blocks, once a
request), recording on and no profiler (``_spans``), in ms; nothing where
the program records no such span."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "text_encode")

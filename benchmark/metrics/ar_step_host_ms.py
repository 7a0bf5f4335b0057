"""ar_step_host_ms: the mean host duration of the program's ``ar.step``
span (one AR decode step: a graph replay on the card), recording on and no
profiler (``_spans``), in ms; nothing where the program records no such
span."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "ar.step")

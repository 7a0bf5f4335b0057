"""step_host_ms: the mean host duration of the program's ``sampler.step``
span (one DiT forward, the update and the draw), recording on and no
profiler (``_spans``), in ms."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "sampler.step")

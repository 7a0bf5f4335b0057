"""capture_host_ms: the mean host duration of the program's
``sampler.capture`` span (the capture of the DiT step's CUDA graph, once a
request, with the eager warm-up of a shape not run before in the
process), recording on and no profiler (``_spans``), in ms; nothing where
the program records no such span."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "sampler.capture")

"""step_launches: device kernels (copies and fills left out) whose launch
calls lie inside the program's ``sampler.step`` spans, per step, under the
profiler (``_spans``)."""

from ._spans import kernels_per_span


def read(run):
    return kernels_per_span(run, "sampler.step")

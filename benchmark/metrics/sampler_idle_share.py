"""sampler_idle_share: over each request's ``sampler`` span (the DDPM
loop), of the device interval from its first to its last operation, the
share that no operation launched inside it covers, summed over the traced
requests, in % (``_spans``)."""

from ._spans import idle_share


def read(run):
    return idle_share(run, "sampler")

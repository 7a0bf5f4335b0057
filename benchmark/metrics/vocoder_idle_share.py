"""vocoder_idle_share: as ``sampler_idle_share``, over each request's
``vocoder`` span (BigVGAN), in % (``_spans``)."""

from ._spans import idle_share


def read(run):
    return idle_share(run, "vocoder")

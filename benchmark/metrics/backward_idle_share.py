"""backward_idle_share: as ``sampler_idle_share``, over each step's
``train.backward`` span, in % (``_spans``)."""

from ._spans import idle_share


def read(run):
    return idle_share(run, "train.backward")

"""ar_idle_share: as ``sampler_idle_share``, over each request's ``ar``
span (the AR prefill and decode), in % (``_spans``)."""

from ._spans import idle_share


def read(run):
    return idle_share(run, "ar")

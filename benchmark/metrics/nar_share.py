"""nar_share: as ``ar_share``, over each request's ``nar`` span (VALL-E's
7 NAR stages), in % (``_spans``, phase (b)); nothing where the program
records no ``nar`` span."""

from .ar_share import share


def read(run):
    return share(run, "nar")

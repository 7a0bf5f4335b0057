"""ar_share: of the device time of the operations launched inside each
request's ``request`` span, the share launched inside its ``ar`` span
(the AR prefill and decode), over the traced requests, in % (``_spans``,
phase (b)); nothing where the program records no ``ar`` span."""

from ._spans import _named_ops, phases


def share(run, name: str):
    """Of the device time under the traced requests' ``request`` spans,
    the share under the spans named ``name``, in %; None where there is
    none."""
    p = phases(run)
    if not p:
        return None
    total = sum(e - s for ops in _named_ops(p, "request") for _, s, e in ops)
    part = sum(e - s for ops in _named_ops(p, name) for _, s, e in ops)
    return 100.0 * part / total if total > 0 and part > 0 else None


def read(run):
    return share(run, "ar")

"""launches_per_req: device kernels (copies and fills left out) in the
profiler's trace of the traced window, per request."""

from ..core import kernel_ops


def read(run):
    t = getattr(run, "trace", None)
    if not t:
        return None
    n = len(kernel_ops(t))
    return n / run.trace_requests if n else None

"""A kernel family's share of its roofline: the least time of the work
its calls do (counted from the configuration's shapes in
``benchmark/work``), over the device time of the traced kernels whose
names match the family, in %. Nothing is returned where no such kernel
ran."""

from ..work.peaks import least_seconds


def share(run, work_key: str, names):
    t = getattr(run, "trace", None)
    if not t:
        return None
    dev_s = sum((e - s) / 1e6 for n, s, e in t["ops"]
                if any(k in n.lower() for k in names))
    if dev_s <= 0:
        return None
    calls = run.traffic.work(run)[work_key]
    least = sum(least_seconds(f, b, dt) for f, b, dt in calls)
    return 100.0 * least * run.trace_requests / dev_s

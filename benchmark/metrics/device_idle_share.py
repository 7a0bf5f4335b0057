"""device_idle_share: the share of the traced window in which no
operation ran on the card: the window less the union of the device
operations' intervals, over the window, in %."""


def read(run):
    t = getattr(run, "trace", None)
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]

"""mfu: the model's operations of the work the timed phase completed, at
the peak of each part's stated precision (``benchmark/work``), over the
phase's wall seconds, in %: the least time the chip could take for the
work, as a share of the time it took."""


def read(run):
    least = run.traffic.work(run)["model_s"]
    return 100.0 * least * run.window["requests"] / run.window["wall_s"]

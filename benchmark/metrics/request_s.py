"""request_s: the window's wall seconds over the requests it completed
(one client, closed loop: every stall counts)."""


def read(run):
    return run.window["wall_s"] / run.window["requests"]

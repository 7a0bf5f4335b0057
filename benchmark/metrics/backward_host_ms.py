"""backward_host_ms: the mean host duration of the program's
``train.backward`` span (``torch.autograd.grad`` of the step's loss, the
rematerialized forward included), recording on and no profiler
(``_spans``), in ms."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "train.backward")

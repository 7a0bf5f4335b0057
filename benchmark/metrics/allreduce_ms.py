"""allreduce_ms: device milliseconds a training step of the operations
launched inside the program's ``train.allreduce`` spans (each mean over
the data group: the gradient's raveling, all-reduce and split, then the
metrics'), summed over the traced steps and divided by their
``train.step`` spans (``_spans``, phase (b)), on this process's card;
nothing where the program records no such span."""

from ._spans import _named_ops, phases


def read(run):
    p = phases(run)
    if not p:
        return None
    steps = sum(1 for s in p["spans"] if s["name"] == "train.step")
    ns = sum(e - s for ops in _named_ops(p, "train.allreduce")
             for _, s, e in ops)
    return ns / steps / 1e6 if steps and ns > 0 else None

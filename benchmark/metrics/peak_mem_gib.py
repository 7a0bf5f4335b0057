"""peak_mem_gib: the allocator's peak of device memory over the run
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    peak = getattr(run, "peak_bytes", None)
    return None if not peak else peak / 2**30

"""peak_mem_gib (device): ``torch.cuda.max_memory_allocated()`` over the
window, in GiB, on rank 0."""


def read(ctx):
    b = ctx.record.peak_window_bytes
    return b / 2**30 if b else None

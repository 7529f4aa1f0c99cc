"""peak_mem_mib: ``torch.cuda.max_memory_allocated`` over set-up and the
window, in MiB (read before the reference runs)."""


def read(ctx):
    return ctx.outcome.peak_bytes / 2 ** 20 if ctx.outcome.peak_bytes else None

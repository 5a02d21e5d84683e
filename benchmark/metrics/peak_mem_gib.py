"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the window, after
a reset at its start, in GiB; layer: device memory."""


def read(r):
    if not r.peak_bytes:
        return None
    return r.peak_bytes / 2 ** 30

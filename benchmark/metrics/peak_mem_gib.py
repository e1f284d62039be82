"""The device memory the process holds at its peak over the window, in
GiB: ``torch.cuda.max_memory_reserved()``, reset at the window's start
after the allocator's cached free blocks are released. Reserved, because a
CUDA graph's activations live in its private pool, which the allocator
counts as reserved and not as allocated."""


def read(rec):
    return rec.peak_bytes / 2 ** 30 if rec.peak_bytes else None

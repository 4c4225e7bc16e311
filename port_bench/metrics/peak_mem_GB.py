"""The most device memory allocated at once over the window (GB, 1e9 B),
``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start."""


def read(rec):
    return rec.peak_bytes / 1e9

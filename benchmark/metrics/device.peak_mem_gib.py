"""device.peak_mem_gib: the most device memory the program held during
the window (torch.cuda.max_memory_allocated after
reset_peak_memory_stats), in GiB."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**30

"""torch.cuda.max_memory_allocated over the window, reset after set-up."""


def read(run):
    return run.window_peak_bytes / 2 ** 30 if run.window_peak_bytes > 0 else None

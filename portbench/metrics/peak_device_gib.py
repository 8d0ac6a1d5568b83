"""Device: torch.cuda.max_memory_allocated over the window, after a reset
at its start (set-up's dense weights and the reference's work not
counted)."""


def read(run, name):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None

"""Every output token emitted in the window over the window's seconds."""
from portbench.metrics._common import rate, tokens_in_window


def read(run, name):
    return rate(tokens_in_window(run), run.window_s)

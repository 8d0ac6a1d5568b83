"""Device: the share of the traced slice with no kernel running on the card
(copies alone count as idle: the link has its own metric)."""
from portbench.metrics._common import share, traced


def read(run, name):
    busy = traced(run, "kernel_busy_s")
    if busy is None:
        return None
    return share(run.trace["window_s"] - busy, run.trace["window_s"])

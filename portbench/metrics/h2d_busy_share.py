"""Host-to-device link: the share of the traced slice with a host-to-device
copy in flight on the card."""
from portbench.metrics._common import share, traced


def read(run, name):
    busy = traced(run, "h2d_busy_s")
    if busy is None:
        return None
    return share(busy, run.trace["window_s"])

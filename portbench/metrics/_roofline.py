"""A kernel group's share of its roofline over the traced slice: the sum of
its calls' bounds (frozen work functions over each call's shapes) over
the device time of the kernels launched inside the calls' ranges."""
from portbench.metrics._common import share


def read_group(run, group):
    t = run.trace
    if not t or not t["calls"].get(group) or not t["device_ms"].get(group):
        return None
    return share(t["bound_ms"][group], t["device_ms"][group])

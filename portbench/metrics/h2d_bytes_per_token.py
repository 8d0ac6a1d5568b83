"""Expert pool: h2d bytes the pool and the prefill tier issued in the
window over the output tokens emitted in it."""
from portbench.metrics._common import h2d_bytes, tokens_in_window


def read(run, name):
    n = tokens_in_window(run)
    return h2d_bytes(run) / n if n else None

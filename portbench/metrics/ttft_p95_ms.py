"""95th percentile, over every request whose first token falls in the
window (and every request that failed in it, as +inf), of submit to
first token on the host clock: the wait for a slot included."""
from portbench.metrics._common import percentile


def read(run, name):
    vals = []
    for r in run.requests:
        if r.failed and r.done_t is not None and run.in_window(r.done_t):
            vals.append(float("inf"))
        elif r.token_t and run.in_window(r.token_t[0]):
            vals.append((r.token_t[0] - r.submit_t) * 1e3)
    return percentile(vals, 95)

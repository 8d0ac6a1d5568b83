"""95th percentile of every gap between successive output tokens of every
request, both tokens in the window."""
from portbench.metrics._common import percentile


def read(run, name):
    gaps = [(b - a) * 1e3 for r in run.requests
            for a, b in zip(r.token_t[:-1], r.token_t[1:])
            if run.in_window(a) and run.in_window(b)]
    return percentile(gaps, 95)

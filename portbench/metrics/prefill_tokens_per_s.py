"""Serving engine, admission: prompt tokens the executor's chunk calls took
in the window over its seconds."""
from portbench.metrics._common import rate


def read(run, name):
    return rate(run.counters["prompt_tokens"], run.window_s)

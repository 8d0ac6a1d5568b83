"""Executor: kernel launches the card ran in the traced slice (copies and
fills not counted) over the engine steps in it."""
from portbench.metrics._common import traced


def read(run, name):
    n = traced(run, "launches")
    if n is None or not run.trace["steps"]:
        return None
    return n / run.trace["steps"]

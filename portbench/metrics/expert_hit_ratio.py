"""Expert pool: (hits + speculative hits) over accesses in the window, from
the pool's own counters, in percent."""
from portbench.metrics._common import share


def read(run, name):
    c = run.counters
    served = c["hits"] + c["spec_hits"]
    return share(served, served + c["demand_loads"])

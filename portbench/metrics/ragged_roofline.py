"""Share of the roofline of paged attention, ``ragged_mma.cu``: over the
admission chunks' calls for ``.prefill``, the decode rows' otherwise."""
from portbench.metrics._roofline import read_group


def read(run, name):
    return read_group(run, "ragged_prefill" if name.endswith(".prefill")
                      else "ragged_decode")

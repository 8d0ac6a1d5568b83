"""Share of the roofline of the admission chunks' expert products: the
grouped binding, ``dequant_grouped.cu``."""
from portbench.metrics._roofline import read_group


def read(run, name):
    return read_group(run, "grouped")

"""Share of the roofline of the decode rows' expert products: the slots
binding, ``dequant_gemv.cu`` (and its FMA route above 8 rows a record)."""
from portbench.metrics._roofline import read_group


def read(run, name):
    return read_group(run, "gemv")

"""The MLP kernels' share of their roofline, in percent: every kernel
record of the window counts, since in an MLP cell all the card's work is
the MLP decode's."""

from benchmark.readers import roofline


def read(run):
    return roofline(run, "mlp")

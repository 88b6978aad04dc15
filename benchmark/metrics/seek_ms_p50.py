"""The median request latency of the window, in ms."""

from benchmark.readers import latency_quantile


def read(run):
    return latency_quantile(run, 50)

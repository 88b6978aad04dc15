"""The card's idle share of the window, in percent, from the device
trace, gated against the launch counters."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)

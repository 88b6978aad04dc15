"""The PCM unpack kernels' share of their roofline, in percent: the
kernels of the window launched outside the CPPM hook's range, whatever
their names (in a PCM cell the card does nothing else)."""

from benchmark.readers import roofline


def read(run):
    return roofline(run, "pcm", lambda ranges: "cppm.hook" not in ranges)

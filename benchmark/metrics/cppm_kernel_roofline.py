"""The CPPM decrypt kernels' share of their roofline, in percent: the
kernels launched inside the CPPM hook (the benchmark's ``cppm.hook``
range around the ``decrypt=`` callback), whatever their names."""

from benchmark.readers import roofline


def read(run):
    return roofline(run, "cppm", lambda ranges: "cppm.hook" in ranges)

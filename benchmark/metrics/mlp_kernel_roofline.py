"""The MLP kernels' share of their roofline, in percent.  On an encrypted
disc (the run's work has a ``cppm`` layer) the card also runs the CPPM
decrypt, so only the kernels launched outside the CPPM hook's range
count, whatever their names.  On a plain disc all the card's work is the
MLP decode's: every kernel record of the window counts, and no record
has to be tied to its launch."""

from benchmark.readers import roofline


def read(run):
    if "cppm" in run.work:
        return roofline(run, "mlp", lambda ranges: "cppm.hook" not in ranges)
    return roofline(run, "mlp")

"""The share, in percent, of the MLP kernels' card time that was launched
inside the port's ``mlp/redo`` range: the chunks the narrow readback runs
again at a wider tier once their flag says they overflowed their own
(``native_engine._Drain._resolve``).  The MLP kernels are those
``mlp_kernel_roofline`` counts: on an encrypted disc (the run's work has a
``cppm`` layer) the kernels launched outside the CPPM hook's range, else
every kernel.  Reads nothing where some kernel record cannot be tied to
its launch, or where no record was launched inside ``mlp/redo``: a
program without that range, or a run that ran no chunk again."""


def read(run):
    t = run.trace_result
    if t is None or t.gate or t.unattributed:
        return None
    encrypted = "cppm" in run.work

    def mlp(ranges):
        return not encrypted or "cppm.hook" not in ranges

    def redo(ranges):
        return "mlp/redo" in ranges and mlp(ranges)

    total = t.kernel_seconds(mlp)
    if total <= 0 or not any(r is not None and redo(r)
                             for *_, r in t.records):
        return None
    return 100.0 * t.kernel_seconds(redo) / total

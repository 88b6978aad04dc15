"""What the per-layer metric readers (``benchmark/metrics/<name>.py``)
share.  Each reader is ``read(run) -> float | None`` over the run's
:class:`~benchmark.harness.RunContext`; None leaves the metric out of
the result line, and a reader returns None wherever it finds nothing to
read: no audio decoded, a stage that never ran, no trace, or a trace
whose records failed the launch-counter gate."""

from __future__ import annotations

import statistics

from .roofline import share

__all__ = ["stage_ms_per_audio_s", "span_ms_per_audio_s", "roofline",
           "idle_share", "latency_quantile"]


def stage_ms_per_audio_s(run, stage: str) -> float | None:
    """A ``global_timer`` stage's milliseconds over the window per audio
    second the window decoded."""
    if run.audio_s <= 0 or stage not in run.stages:
        return None
    return 1e3 * run.stages[stage] / run.audio_s


def span_ms_per_audio_s(run, span: str) -> float | None:
    """The same of one of the benchmark's own spans."""
    if run.audio_s <= 0 or span not in run.spans:
        return None
    return 1e3 * run.spans[span] / run.audio_s


def _trace(run):
    t = run.trace_result
    return None if t is None or t.gate else t


def roofline(run, layer: str, launched_in=None) -> float | None:
    """The layer's roofline share, in percent: the least time of its
    logical work (``run.work[layer]``) over its kernels' record time in
    the window.  ``launched_in`` picks the layer's kernels by the set of
    benchmark ranges that held each launch (every kernel without one);
    where some records cannot be tied to their launch, it reads
    nothing."""
    t = _trace(run)
    if t is None or layer not in run.work:
        return None
    if launched_in is not None and t.unattributed:
        return None
    w = run.work[layer]
    return share(run.device_kind, w["bytes"], w["ops"],
                 t.kernel_seconds(launched_in))


def idle_share(run) -> float | None:
    """The card's idle share of the window in percent: 1 − the union of
    its kernel, copy and fill records over the window's wall."""
    t = _trace(run)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def latency_quantile(run, q: int) -> float | None:
    """The ``q``-th percentile of the window's request latencies."""
    lat = run.latencies_ms
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[q - 1]

"""Tracing & profiling — the observability subsystem.

The port's copy of dvda_tpu/utils/profiling.py, with its stages on
``torch.profiler``'s clock, and the card-side timers the port's smoke
run, timing tool and bench share.  The reference has no instrumentation
beyond a per-byte callback usable as a byte counter (SURVEY §5:
bitstream.h:350-375, bitstream.c:3982).  The rebuild provides:

* :class:`StageTimer` — wall-clock accounting per pipeline stage (parse,
  assembly, device, transfers), used by the bench and exposed on
  decoders; while a ``torch.profiler`` capture runs, each stage is also a
  ``record_function`` range of its name, so a trace names the host work;
* :func:`device_ms` / :func:`events_ms` — CUDA-event timers of a call: its
  card time with every call queued ahead, and its time back to back (which
  holds the host's time between launches);
* :func:`device_idle_share` — the card's idle share over one call, from a
  ``torch.profiler`` capture whose kernel records are checked against the
  port's launch counters.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = ["StageTimer", "global_timer", "device_ms", "events_ms",
           "device_idle_share", "kernel_counters", "kernel_launches"]


class StageTimer:
    """Accumulates wall-clock seconds and entries per named stage."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block under ``name``.  While a ``torch.profiler``
        capture runs, the block is also a ``record_function`` range of
        that name, opened before the clock starts and closed after it
        stops; without one, the check costs a fraction of a microsecond
        where the range would cost some ten."""
        rf = None
        if _profiler_enabled():  # a capture is running
            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            if rf is not None:
                rf.__exit__(None, None, None)

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


#: process-wide timer used by the decoders when none is injected
global_timer = StageTimer()


# -- the card's clock -------------------------------------------------------

def events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls made back to back, by
    CUDA events: the card's time, or the host's between launches where that
    is longer (a wrapper's checks and allocation)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds of card time per call of ``fn``: CUDA events
    around ``reps`` calls that the host queues while the card is held in
    a spin kernel, so that the card then runs them back to back.  Unlike
    :func:`events_ms` it leaves out the host's time between launches,
    which exceeds a short kernel's (a wrapper's checks and allocation take
    tens of us).  If the spin ends before the last call is queued, the run
    is repeated with a spin twice as long.  CUDA's launch queue is
    finite: where ``reps`` calls of many launches fill it, the host blocks
    behind the spin and this raises, so time such a call with few
    ``reps``."""
    import torch

    cycles = 20_000_000  # ~10 ms at the H100's clock
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        spun.record()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued = not spun.query()  # the card still spinning: all queued
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / reps
        cycles *= 2
    raise RuntimeError("device_ms: the host did not queue the calls within "
                       "a 160 ms spin")


# -- the card's idle share --------------------------------------------------

def kernel_counters() -> dict:
    """Each port kernel's name in a profiler record (its ``__global__``
    function) and the wrapper counters that count its launches."""
    from ..ops.c2_decrypt import decrypt_sectors_device
    from ..ops.chunk_filter import chunk_filter
    from ..ops.chunk_lanes import chunk_lanes
    from ..ops.general_gather import lane_pack, series_remix
    from ..ops.huffman_decode import decode_residuals_device
    from ..ops.mlp_filter import mlp_filter_blocks_tl
    from ..ops.pcm_unpack import decode_chunks_device
    from ..ops.rematrix import frame_remix, output_stage

    return {"chunk_lanes_kernel": ((chunk_lanes, "launches"),),
            "mlp_filter_kernel": ((mlp_filter_blocks_tl, "launches"),),
            "mlp_filter_arena_kernel": ((chunk_filter, "launches"),),
            # K234 and K234n launch one kernel
            "output_stage_kernel": ((output_stage, "launches"),
                                    (output_stage, "narrow_launches")),
            "huffman_decode_kernel": ((decode_residuals_device, "launches"),),
            "pcm_unpack_kernel": ((decode_chunks_device, "launches"),),
            "c2_decrypt_kernel": ((decrypt_sectors_device, "launches"),),
            "lane_pack_kernel": ((lane_pack, "launches"),),
            "series_remix_kernel": ((series_remix, "launches"),),
            "frame_remix_kernel": ((frame_remix, "launches"),)}


def kernel_launches() -> dict[str, int]:
    """The port's launch counters now, by kernel name."""
    return {name: sum(getattr(fn, attr) for fn, attr in pairs)
            for name, pairs in kernel_counters().items()}


def _profile_call(fn, lead_s: float = 0.0) -> tuple[float, list]:
    """(wall seconds, device records) of one call of ``fn`` under a
    ``torch.profiler`` capture with CPU and CUDA activities, made
    ``lead_s`` of host sleep into the capture (``torch_timing_check.py
    profiler`` varies it) and ended by a synchronise.  A record is (name,
    start us, end us): every kernel, memcpy and memset the card ran in
    the capture."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(lead_s)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # a record_function range projected on the card's timeline is no work
    return wall, [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]


def _busy_us(records: list) -> float:
    """Microseconds covered by the union of the records' intervals."""
    busy, end = 0.0, None
    for _, lo, hi in sorted(records, key=lambda r: r[1]):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy


def device_idle_share(fn) -> tuple[float | None, dict]:
    """Run ``fn`` once under ``torch.profiler`` and return (the card's idle
    share of the call's wall, the records behind it).  Busy time is the
    union of every kernel, memcpy and memset interval the capture holds;
    the wall is the host's clock around ``fn`` and a synchronise, with the
    profiler on (its cost is in the wall, so the share leans high).

    The profiler has lost records on this port's runs, so the count of
    each port kernel's records is held against its launch counter over
    the same call: on any difference the share is None and ``reason``
    names the kernel and both counts.  Raises without CUDA."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("device_idle_share needs a CUDA device")
    before = kernel_launches()
    wall, records = _profile_call(fn)
    after = kernel_launches()
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    kinds = defaultdict(int)
    for name, _, _ in records:
        ours = [k for k in after if k in name]
        kinds[ours[0] if ours else "memcpy" if name.startswith("Memcpy")
              else "memset" if name.startswith("Memset") else "other"] += 1
    busy = _busy_us(records) / 1e3
    detail = {"wall_ms": wall * 1e3, "busy_ms": busy,
              "records": dict(kinds), "launches": launches, "reason": None}
    lost = [f"{k}: {kinds.get(k, 0)} records, {n} launches"
            for k, n in sorted(launches.items()) if kinds.get(k, 0) != n]
    lost += [f"{k}: {kinds[k]} records, 0 launches"
             for k in after if kinds.get(k, 0) and k not in launches]
    if lost:
        detail["reason"] = ("the profiler's kernel records disagree with "
                            "the launch counters: " + "; ".join(lost))
        return None, detail
    return max(0.0, 1.0 - busy / detail["wall_ms"]), detail

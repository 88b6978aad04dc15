"""The ``--trace 1`` run's device trace: one ``torch.profiler`` capture
with CPU and CUDA activities, from before the program is imported to the
end of the measured window.

The capture starts first thing in the process because on the H100 a
capture that starts after some tens of seconds without one has been seen
to lose its card records (the port's PERF.md, runs Z2-Z5).  Only the
records inside the window, which the harness marks with the
``bench.window`` range, are read.  They are held against the port's
launch counters over the window, as the port's ``device_idle_share``
does: where a port kernel's record count differs from its launch count,
:attr:`TraceResult.gate` names the difference and the readers of the
device trace read nothing.

Each kernel record is tied to the benchmark ranges (``RunContext.span``)
that held its launch: the CUDA runtime call with the record's
correlation id, on the thread that made it.  A layer's kernels are then
the records launched inside that layer's range, whatever the program
names them.  Where a kernel record has no launch call in the trace,
:attr:`TraceResult.unattributed` says so and the readers that take
kernels by range read nothing.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

__all__ = ["Capture", "TraceResult", "WINDOW", "read_events"]

WINDOW = "bench.window"


@dataclass
class TraceResult:
    window_s: float
    #: device records in the window: (name, start ns, end ns, ranges),
    #: clipped; ``ranges`` the names of the benchmark ranges that held
    #: the record's launch (a frozenset), None where no launch was found
    records: list = field(default_factory=list)
    busy_s: float = 0.0
    #: None, or why the records cannot be trusted
    gate: str | None = None
    #: None, or why some kernel records cannot be tied to their launch
    unattributed: str | None = None
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, launched_in=None) -> float:
        """Summed time of the kernel records (not copies or fills) whose
        launch ranges ``launched_in`` accepts (all kernels without one;
        a record with no launch found matches no ``launched_in``)."""
        return sum(hi - lo for name, lo, hi, ranges in self.records
                   if not _is_copy(name) and (
                       launched_in is None
                       or ranges is not None and launched_in(ranges))) / 1e9


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals: list) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class Capture:
    """A running capture; :meth:`window` marks the measured window and
    :meth:`finish` stops the capture and reads it."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    @contextlib.contextmanager
    def window(self):
        from torch.profiler import record_function

        with record_function(WINDOW):
            yield

    def finish(self, launches: dict) -> TraceResult:
        """Stop, and read the window.  ``launches``: the port's launch
        counts over the window by kernel name (``kernel_launches()``
        deltas)."""
        self._prof.stop()
        return read_events(self._prof.profiler.kineto_results.events(),
                           launches)


def read_events(events, launches: dict) -> TraceResult:
    """The window's :class:`TraceResult` from a capture's events (the
    profiler's ``kineto_results.events()``)."""
    from torch.autograd import DeviceType

    events = list(events)
    win = [e for e in events if e.name() == WINDOW]
    if len(win) != 1:
        raise RuntimeError(f"{len(win)} window ranges in the trace")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    main = win[0].start_thread_id()
    res = TraceResult(window_s=(w1 - w0) / 1e9)
    device, cpu, annotations, calls = [], [], defaultdict(list), {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(e)
            continue
        lo, hi, tid = e.start_ns(), e.end_ns(), e.start_thread_id()
        if e.is_user_annotation():
            if e.name() != WINDOW:
                annotations[tid].append((lo, hi, e.name()))
        elif _is_cuda_call(e.name()):
            calls[e.correlation_id()] = (tid, lo)
        if tid == main and e.name() != WINDOW and hi > w0 and lo < w1:
            cpu.append((lo, hi, e.name(), e.is_user_annotation()))
    device = [e for e in device if e.end_ns() > w0 and e.start_ns() < w1]
    ranges = _launch_ranges([calls.get(e.correlation_id()) for e in device],
                            annotations)
    lost = 0
    for e, held in zip(device, ranges):
        res.records.append((e.name(), max(e.start_ns(), w0),
                            min(e.end_ns(), w1), held))
        lost += held is None and not _is_copy(e.name())
    if lost:
        res.unattributed = (f"{lost} kernel records of the window have no "
                            "launch call in the trace")
    busy = _union([(lo, hi) for _, lo, hi, _ in res.records])
    res.busy_s = sum(hi - lo for lo, hi in busy) / 1e9
    res.gate = _gate(res.records, launches)
    by_name = defaultdict(int)
    for name, lo, hi, _ in res.records:
        by_name[name] += hi - lo
    res.device_ops = [[n, t / 1e9] for n, t in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    res.idle_gaps = _label_gaps(busy, w0, w1, cpu)
    return res


def _is_cuda_call(name: str) -> bool:
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``...): the host side of a
    device record, which shares its correlation id."""
    return name.startswith("cu") and "::" not in name


def _launch_ranges(launches: list, annotations: dict) -> list:
    """For each launch, (thread, time) or None, the frozenset of the
    names of the ranges on that thread that hold it (None where the
    launch is None)."""
    out = [None] * len(launches)
    by_thread = defaultdict(list)
    for i, launch in enumerate(launches):
        if launch is not None:
            by_thread[launch[0]].append((launch[1], 1, i))
    for tid, points in by_thread.items():
        # a sweep: range starts, then launches, then range ends at a tie
        for lo, hi, name in annotations.get(tid, ()):
            points += [(lo, 0, name), (hi, 2, name)]
        active = defaultdict(int)
        for _, kind, what in sorted(points, key=lambda p: (p[0], p[1])):
            if kind == 0:
                active[what] += 1
            elif kind == 2:
                active[what] -= 1
            else:
                out[what] = frozenset(n for n, c in active.items() if c > 0)
    return out


def _gate(records: list, launches: dict) -> str | None:
    counts = defaultdict(int)
    for name, _, _, _ in records:
        for k in launches:
            if k in name:
                counts[k] += 1
                break
    lost = [f"{k}: {counts[k]} records, {n} launches"
            for k, n in sorted(launches.items()) if counts[k] != n]
    if lost:
        return ("the profiler's kernel records disagree with the launch "
                "counters: " + "; ".join(lost))
    return None


def _label_gaps(busy: list, w0: int, w1: int, cpu: list) -> list:
    """Idle time in the window, summed by what the main thread was doing
    meanwhile: each part of a gap by the innermost range that holds it
    ("outside" where none does) and the innermost operation at the
    part's middle.  The ten largest sums, in seconds.

    The ranges are exact however many a long one holds: the window is
    cut where a range starts or ends, and one sweep over the cuts keeps
    the stack of open ranges, whose top labels the piece up to the next
    cut.  The operation suffix keeps :func:`_innermost`'s bounded
    look-back over the operations."""
    spans = [(lo, hi, name) for lo, hi, name, ours in cpu if ours]
    ops = sorted((lo, hi, name) for lo, hi, name, ours in cpu if not ours)
    # the window cut where a range starts or ends
    cuts = sorted({w0, w1} | {x for lo, hi, _ in spans for x in (lo, hi)
                              if w0 < x < w1})
    labels = _open_ranges(spans, cuts)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    totals = defaultdict(int)
    for lo, hi in zip(edges[0::2], edges[1::2]):
        a, i = lo, bisect.bisect_right(cuts, lo)
        while a < hi:
            b = min(cuts[i], hi) if i < len(cuts) else hi
            op = _innermost(ops, (a + b) // 2)
            label = labels[i - 1]
            totals[f"{label} > {op}" if op else label] += b - a
            a, i = b, i + 1
    return [[n, t / 1e9] for n, t in sorted(
        totals.items(), key=lambda kv: -kv[1])[:10]]


def _open_ranges(spans: list, cuts: list) -> list:
    """For each piece ``[cuts[k], cuts[k + 1])`` of the window, the name
    of the innermost range of ``spans`` (one thread's ranges) that holds
    it, or "outside".  A range that holds a piece starts at or before its
    cut and ends at or after the next; of ranges that start together the
    shorter is the inner one."""
    starts = sorted((s for s in spans if s[1] > s[0]),
                    key=lambda s: (s[0], -s[1]))
    ends = sorted(range(len(starts)), key=lambda j: starts[j][1])
    stack, closed, out = [], [False] * len(starts), []
    i = e = 0
    for cut in cuts[:-1]:
        while e < len(ends) and starts[ends[e]][1] <= cut:
            closed[ends[e]] = True
            e += 1
        while i < len(starts) and starts[i][0] <= cut:
            stack.append(i)
            i += 1
        # a closed range below the top (ranges that do not nest) goes
        # once the top reaches it
        while stack and closed[stack[-1]]:
            stack.pop()
        out.append(starts[stack[-1]][2] if stack else "outside")
    return out


def _innermost(events: list, t: int, depth: int = 64) -> str | None:
    """The name of the latest-starting event of ``events`` (sorted by
    start) that holds ``t``: on one thread's nested ranges, the innermost
    (the search looks back ``depth`` events: enough for the operations;
    the ranges are labelled by :func:`_open_ranges`)."""
    i = bisect.bisect_right(events, (t, float("inf"), "")) - 1
    for j in range(i, max(-1, i - depth), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None

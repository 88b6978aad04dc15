"""The end-to-end metrics take all the work and all the time of the
window, and the rooflines count the logical work (CPU)."""

from __future__ import annotations

import itertools
import time

import pytest

from benchmark.drivers import rip, seek
from benchmark.harness import RunContext
from benchmark.reference.expected import _CountingDecoder
from benchmark.reference.mlp_spec import (ChannelState, MatrixState,
                                          SubstreamState)
from benchmark import roofline
from benchmark.trace import WINDOW


class _FakeTrack:
    def __init__(self, frames):
        self.pcm_frames, self.layout = frames, None


class _FakeReader:
    """Answers at once, except the decodes or requests listed in
    ``stall`` (counted across readers), which take ``delay`` seconds."""

    calls = 0

    def __init__(self, stall, delay):
        self.stall, self.delay = stall, delay

    def _tick(self):
        if _FakeReader.calls in self.stall:
            time.sleep(self.delay)
        _FakeReader.calls += 1

    def read_all_packed(self):
        self._tick()
        return b""

    def seek(self, pos):
        return pos

    def read(self, n):
        self._tick()
        return None

    def close(self):
        pass


def _driver(mod, monkeypatch, stall, delay, traffic):
    ctx = RunContext("fake", {"sample_rate": 1000}, traffic, 1, False,
                     "/nonexistent")
    d = mod.Driver(ctx, None)
    d.tracks = [0, 1, 2, 3]
    d.seconds = [0.05] * 4
    d.album = type("A", (), {"tracks": [_FakeTrack(1000)] * 4})()
    _FakeReader.calls = 0
    monkeypatch.setattr(d, "open_reader",
                        lambda n: _FakeReader(stall, delay))
    return d


@pytest.mark.parametrize("stall", [set(), {3}])
def test_x_realtime_counts_a_stalled_decode(monkeypatch, stall):
    d = _driver(rip, monkeypatch, stall, 0.3,
                {"warmup_seconds": 0, "compare_share": 0.0})
    d.setup()
    _FakeReader.calls = 0   # stall the window's decodes, not the warm-up's
    d.window(0.2)
    x = d.end_to_end()["x_realtime"]
    # every finished decode's audio over every second of the window
    assert x == pytest.approx(0.05 * len(d.done) / d.elapsed)
    if stall:
        assert d.elapsed >= 0.3 and x < 0.05 * len(d.done) / 0.3 + 1e-9


def test_seek_tail_counts_stalled_requests(monkeypatch):
    traffic = {"read_seconds": 0.001, "warmup_seconds": 0,
               "segment_seconds": 0.25, "deck": ["open", "move"]}
    quick = _driver(seek, monkeypatch, set(), 0.0, traffic)
    quick.setup()
    quick.window(0.05)
    n = len(quick.ctx.latencies_ms)
    slow = _driver(seek, monkeypatch, set(range(0, 10 ** 6, 3)), 0.01,
                   traffic)
    slow.setup()
    slow.window(0.3)
    # one request in three stalls: p75 is a stalled one, over all requests
    assert n > 10
    assert slow.end_to_end()["seek_ms_p75"] >= 10.0
    assert quick.end_to_end()["seek_ms_p75"] < 10.0


@pytest.mark.parametrize("mod,least", [(rip, 4), (seek, 1)])
def test_the_warm_up_runs_its_seconds(monkeypatch, mod, least):
    traffic = {"warmup_seconds": 0.2, "compare_share": 0.0,
               "read_seconds": 0.001, "segment_seconds": 0.25,
               "deck": ["open", "move"]}
    d = _driver(mod, monkeypatch, set(range(10 ** 6)), 0.01, traffic)
    t0 = time.perf_counter()
    d.setup()
    # whole decodes or requests until the seconds are done (a rip: at
    # least one pass over the album's four tracks)
    assert time.perf_counter() - t0 >= 0.2
    assert least <= _FakeReader.calls <= 0.2 / 0.01 + 2


@pytest.mark.parametrize("deck", [["open", "open", "open", "move"],
                                  ["open", "move", "move"]])
def test_every_seed_draws_the_same_seek_work(monkeypatch, deck):
    traffic = {"read_seconds": 0.01, "segment_seconds": 0.25,
               "deck": deck, "warmup_seconds": 0}
    drawn = []
    for seed in (1, 2 ** 31 + 7):
        d = _driver(seek, monkeypatch, set(), 0.0, traffic)
        d.ctx.seed = seed
        d.setup()
        track, segment = d._track, d._segment
        kinds = []
        for n, pos, seg in itertools.islice(
                seek._requests(d, 1, track, segment), 10 * len(deck)):
            # every read inside one segment of its track
            assert seg * 250 <= pos and pos + 10 <= min((seg + 1) * 250,
                                                          1000)
            kinds.append("open" if n != track else "move")
            assert n != track or seg != segment
            track, segment = n, seg
        # each pass over the deck holds its kinds, in a seed-drawn order
        for i in range(0, len(kinds), len(deck)):
            assert sorted(kinds[i:i + len(deck)]) == sorted(deck)
        drawn.append(kinds)
    assert drawn[0] != drawn[1]


def test_mlp_counts_taps_and_used_coefficients():
    dec = _CountingDecoder.__new__(_CountingDecoder)
    dec.macs = 0
    ss = SubstreamState()
    ch = ss.channels[0]
    ch.fir.coeff, ch.iir.coeff = [1, 2], [3]
    ch.fir.shift = ch.iir.shift = 8
    ss.residuals = {0: [0] * 5}
    dec._filter_channel(ss, 0)
    assert dec.macs == 3 * 5
    ss.max_matrix_channel = 1
    m = MatrixState()
    m.coeff = [1, 0, 4, 0, 0, 0, 0, 0]   # 2 of the 4 (2 ch + 2 noise) used
    ss.matrix_slots[0] = m
    ss.matrix_len = 1
    dec._framelist = [[1] * 4 for _ in range(8)]
    dec._rematrix(ss)
    assert dec.macs == 15 + 2 * 4
    assert isinstance(ch, ChannelState)


def test_roofline_share_is_the_least_time_over_kernel_time():
    kind = "NVIDIA H100 80GB HBM3"
    # 3.35 GB take 1 ms at 3.35 TB/s; 67 G operations take 1 ms too
    assert roofline.share(kind, 3.35e9, 0, 2e-3) == pytest.approx(50.0)
    assert roofline.share(kind, 0, 67e9 * 2, 4e-3) == pytest.approx(50.0)
    assert roofline.share(kind, 1.0, 1.0, 0.0) is None
    assert roofline.share("a CPU", 1.0, 1.0, 1.0) is None


def test_cppm_operations_per_sector():
    g = 10 * roofline.KEY_ROUND_OPS + 10 * roofline.FEISTEL_OPS
    span = 240 * 10 * roofline.FEISTEL_OPS + (10 + 2 * 239) * \
        roofline.KEY_ROUND_OPS
    assert roofline.cppm_ops_per_sector() == 5 * g + span


class _Event:
    """A stand-in for the profiler's kineto event."""

    def __init__(self, name, lo, hi, tid=1, cuda=False, ann=False, corr=0):
        self._v = (name, lo, hi, tid, cuda, ann, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[4] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]


def _capture(lost_launch: bool):
    ev = [_Event(WINDOW, 0, 10_000, ann=True),
          _Event("rip.read_all_packed", 10, 9_000, ann=True),
          _Event("cppm.hook", 100, 200, ann=True),
          _Event("cppm.hook", 300, 400, ann=True),
          _Event("aten::empty", 120, 130, corr=1),
          # K7 launched twice inside the hook, K8 after it, one kernel
          # from another thread, whatever their names
          _Event("cudaLaunchKernel", 150, 155, corr=11),
          _Event("cudaLaunchKernel", 350, 355, corr=12),
          _Event("cudaLaunchKernel", 500, 505, corr=13),
          _Event("cuLaunchKernel", 320, 325, tid=2, corr=14),
          _Event("a_renamed_decrypt", 1_000, 2_000, cuda=True, corr=11),
          _Event("a_renamed_decrypt", 2_000, 3_000, cuda=True, corr=12),
          _Event("fused_unpack", 3_000, 3_500, cuda=True, corr=13),
          _Event("other_thread", 3_500, 3_600, cuda=True, corr=14),
          _Event("Memcpy HtoD", 4_000, 5_000, cuda=True, corr=99)]
    if lost_launch:
        ev.append(_Event("no_launch", 6_000, 6_100, cuda=True, corr=77))
    return ev


@pytest.mark.parametrize("lost_launch", [False, True])
def test_kernels_are_taken_by_the_range_of_their_launch(lost_launch):
    from benchmark.readers import roofline
    from benchmark.trace import read_events

    t = read_events(_capture(lost_launch), {})
    hook = t.kernel_seconds(lambda r: "cppm.hook" in r)
    rest = t.kernel_seconds(lambda r: "cppm.hook" not in r)
    assert hook == pytest.approx(2_000e-9)
    assert rest == pytest.approx(600e-9)
    assert t.kernel_seconds() == pytest.approx((2_600 + 100 * lost_launch)
                                               * 1e-9)
    assert t.busy_s == pytest.approx((3_600 + 100 * lost_launch) * 1e-9)
    run = RunContext("fake", {}, {}, 1, True, "/nonexistent")
    run.trace_result, run.device_kind = t, "NVIDIA H100 80GB HBM3"
    run.work = {"cppm": {"bytes": 3.35e3, "ops": 0.0}}
    got = roofline(run, "cppm", lambda r: "cppm.hook" in r)
    if lost_launch:
        # a kernel record with no launch call: the layer cannot be told
        assert t.unattributed and got is None
        assert roofline(run, "cppm") is not None
    else:
        # 3.35 kB take 1 ns at 3.35 TB/s, over 2 us of hook kernels
        assert t.unattributed is None and got == pytest.approx(0.05)


@pytest.mark.parametrize("lost_launch", [False, True])
@pytest.mark.parametrize("encrypted", [False, True])
def test_mlp_roofline_leaves_out_the_cppm_hook(lost_launch, encrypted):
    from benchmark.harness import _reader
    from benchmark.trace import read_events

    run = RunContext("fake", {}, {}, 1, True, "/nonexistent")
    run.trace_result = read_events(_capture(lost_launch), {})
    run.device_kind = "NVIDIA H100 80GB HBM3"
    run.work = {"mlp": {"bytes": 3.35e3, "ops": 0.0}}
    if encrypted:
        run.work["cppm"] = {"bytes": 3.35e3, "ops": 0.0}
    got = _reader("mlp_kernel_roofline")(run)
    if not encrypted:
        # a plain disc: every kernel record, tied to a launch or not
        assert got == pytest.approx(100 / (2_600 + 100 * lost_launch))
    elif lost_launch:
        assert got is None
    else:
        # 1 ns of work over the 600 ns of kernels launched outside the hook
        assert got == pytest.approx(100 / 600)

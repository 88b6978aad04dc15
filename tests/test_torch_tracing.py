"""The port's stages as ``torch.profiler`` ranges (CPU): none without a
capture, and under one each stage a range of its name, the new stages
holding no other stage, every stage either one that
``benchmark/metrics/decode_unstaged_ms.py`` subtracts or nested in one,
the narrow readback's redo a stage of its own inside one, the CPPM
decryptor's copies inside its decrypt inside the walk, and
``utils.profiling``'s ``device_idle_share`` on a faked card."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvda_tpu_torch import DecodeConfig, host, open_disc
from dvda_tpu_torch.api import TrackReader
from dvda_tpu_torch.codecs.mlp.native_engine import decode_native
from dvda_tpu_torch.container.aob import AOBReader
from dvda_tpu_torch.cppm.decrypt import CppmDecryptor
from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl
from dvda_tpu_torch.testutil import (MlpSynthConfig, MlpTrackSpec,
                                     PcmTrackSpec, build_disc,
                                     encrypt_sectors_batch, synth_mlp_stream)
from dvda_tpu_torch.utils import profiling

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")

CPU = DecodeConfig(device="cpu")
MEDIA_KEY, ALBUM = 0x00DEADBEEF001122, 0x0F0E0D0C0B0A0908
#: the new stages of an unencrypted MLP decode; none holds another stage
NEW = {"mlp/geometry", "mlp/decode-setup", "mlp/throttle", "reader/bytes"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _top_level():
    path = os.path.join(ROOT, "benchmark", "metrics", "decode_unstaged_ms.py")
    spec = importlib.util.spec_from_file_location("decode_unstaged_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return set(mod.TOP_LEVEL)


def _mlp_track(seed):
    c = MlpSynthConfig(channel_assignment=17, substream_count=2,
                       sample_rate=96000, n_frames=48, seed=seed,
                       fir_across_restart=False, params_update_prob=0.0)
    return MlpTrackSpec(mlp_stream=synth_mlp_stream(c),
                        pcm_frames=c.total_pcm_frames, sample_rate=96000,
                        channel_assignment=17)


def _captured(readers):
    """``read_all_packed`` of each reader under one CPU capture: (the
    payloads, the stage ranges on this thread as (start ns, end ns,
    name), the stage entries the timer counted meanwhile)."""
    timer = profiling.global_timer
    before = dict(timer.counts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        data = [r.read_all_packed() for r in readers]
    entered = {k: n - before.get(k, 0) for k, n in timer.counts.items()
               if n > before.get(k, 0)}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation() and e.name() in entered]
    tid = {e.start_thread_id() for e in events}
    assert len(tid) == 1  # the decode's stages run on its own thread
    return data, sorted((e.start_ns(), e.end_ns(), e.name())
                        for e in events), entered


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1] and inner != outer


@pytest.fixture(scope="module")
def mlp_disc(tmp_path_factory):
    return build_disc(str(tmp_path_factory.mktemp("mlp") / "AUDIO_TS"),
                      [[_mlp_track(5)]])


def _mlp_reader(path):
    return (open_disc(path, config=CPU).open_titleset(1).open_title(1)
            .open_track(1).open_reader())


@pytest.fixture(scope="module")
def mlp_capture(mlp_disc):
    reader = _mlp_reader(mlp_disc.path)
    (data,), ranges, entered = _captured([reader])
    assert reader.decode_info["path"] == "pipelined" and data
    return data, ranges, entered


@pytest.fixture(scope="module")
def loud_capture(tmp_path_factory):
    """A loud MLP 2.0/192k/24 track (one 1,280-sample chain a restart,
    output shifts past the 12-bit pair tier): its one chunk, pushed at
    tier 12, overflows and runs again wide.  Also the track's
    ``decode_info`` and the chunks ``mlp_chunks_redone`` counted."""
    c = MlpSynthConfig(channel_assignment=1, sample_rate=192000,
                       block_size=80, n_frames=48, seed=13,
                       fir_across_restart=False, out_shift_range=(6, 8))
    layout = build_disc(str(tmp_path_factory.mktemp("loud") / "AUDIO_TS"),
                        [[MlpTrackSpec(mlp_stream=synth_mlp_stream(c),
                                       pcm_frames=c.total_pcm_frames,
                                       sample_rate=192000,
                                       channel_assignment=1)]])
    reader = _mlp_reader(layout.path)
    before = decode_native.mlp_chunks_redone
    (data,), ranges, entered = _captured([reader])
    assert data
    return (data, ranges, entered, reader.decode_info,
            decode_native.mlp_chunks_redone - before)


@pytest.fixture(scope="module")
def cppm_capture(tmp_path_factory):
    """An encrypted disc (a PCM and an MLP track) read through the
    decryptor's hook."""
    layout = build_disc(str(tmp_path_factory.mktemp("cppm") / "AUDIO_TS"), [[
        PcmTrackSpec(pcm_frames=960, seed=8, sample_rate=96000,
                     bits_per_sample=24, channel_assignment=17),
        _mlp_track(6)]])
    path = os.path.join(layout.path, "ATS_01_1.AOB")
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 2048)
    encrypt_sectors_batch(raw, MEDIA_KEY, ALBUM).tofile(path)
    title = open_disc(layout.path, config=CPU).open_titleset(1).open_title(1)
    dec = CppmDecryptor(MEDIA_KEY, ALBUM, config=CPU)
    readers = [TrackReader(AOBReader(layout.path, 1,
                                     decrypt=dec.decrypt_sectors),
                           title.open_track(n), config=CPU) for n in (1, 2)]
    assert [r.codec for r in readers] == ["PCM", "MLP"]
    return _captured(readers)


def test_no_capture_opens_no_range(mlp_disc, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a capture")

    monkeypatch.setattr(profiling, "record_function", refuse)
    timer = profiling.global_timer
    before = sum(timer.counts.values())
    assert _mlp_reader(mlp_disc.path).read_all_packed()
    assert sum(timer.counts.values()) > before
    with profile(activities=[ProfilerActivity.CPU]):  # the patched call
        with pytest.raises(AssertionError, match="without a capture"):
            with timer.stage("mlp/test"):
                pass


def test_capture_shows_the_new_stages(mlp_disc, mlp_capture):
    data, ranges, entered = mlp_capture
    assert data == _mlp_reader(mlp_disc.path).read_all_packed()
    assert NEW <= set(entered)
    # every entry a range of its name, and nothing else
    names = [n for _, _, n in ranges]
    assert {n: names.count(n) for n in entered} == entered


def test_new_stages_hold_no_stage(mlp_capture):
    _, ranges, _ = mlp_capture
    for outer in ranges:
        if outer[2] in NEW:
            held = [r[2] for r in ranges if _inside(r, outer)]
            assert not held, f"{outer[2]} holds {held}"


@pytest.mark.parametrize("capture", ["mlp_capture", "cppm_capture",
                                     "loud_capture"])
def test_every_stage_is_top_level_or_nested_in_one(request, capture):
    ranges = request.getfixturevalue(capture)[1]
    top = _top_level()
    listed = [r for r in ranges if r[2] in top]
    for r in ranges:
        held_by = [o[2] for o in listed if _inside(r, o)]
        if r[2] in top:
            assert not held_by, f"listed {r[2]} inside {held_by}"
        else:
            assert held_by, f"{r[2]} is neither listed nor inside a listed stage"


def test_redo_is_a_stage_of_its_own(loud_capture):
    """The chunk run again is one ``mlp/redo`` range, holding no other
    stage, inside the top-level stage that read its flag (on the CPU the
    push's, whose copy has landed as it returns); the decode's
    ``info`` and the process-wide counter count it."""
    _, ranges, entered, info, counted = loud_capture
    assert (info["path"], info["chunks"], info["tier"]) == ("pipelined", 1,
                                                            0)
    assert entered["mlp/redo"] == info["redone"] == counted == 1
    top = _top_level()
    assert "mlp/redo" not in top
    for r in ranges:
        if r[2] == "mlp/redo":
            assert not [o for o in ranges if _inside(o, r)]
            # where the flag was read: on the CPU at once, in the push
            assert [o[2] for o in ranges if _inside(r, o)
                    and o[2] in top] == ["mlp/chunk-launch"]


def test_cppm_copies_inside_decrypt_inside_the_walk(cppm_capture):
    _, ranges, entered = cppm_capture
    assert entered["cppm/copy"] >= entered["cppm/decrypt"] > 0
    decrypts = [r for r in ranges if r[2] == "cppm/decrypt"]
    walks = [r for r in ranges if r[2] in ("pcm/assemble", "mlp/assemble")]
    for r in ranges:
        if r[2] == "cppm/copy":
            assert any(_inside(r, d) for d in decrypts)
    for d in decrypts:
        assert any(_inside(d, w) for w in walks)
    # both tracks' walks pulled sectors through the hook
    assert {w[2] for w in walks if any(_inside(d, w) for d in decrypts)} \
        == {"pcm/assemble", "mlp/assemble"}


def test_trace_with_and_without_capture():
    """A stage is a ``record_function`` range under a capture, and none
    without one; its time counts either way."""
    timer = profiling.StageTimer()
    with timer.stage("bench/outside"):
        x = torch.arange(8).sum()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("bench/inside"):
            x = x + torch.arange(8).sum()
    names = [e.name for e in prof.events()]
    assert "bench/inside" in names and "bench/outside" not in names
    assert timer.counts == {"bench/outside": 1, "bench/inside": 1}
    assert int(x) == 56


def _fake_capture(monkeypatch, records, launches):
    """``device_idle_share`` on a fake card: the call launches K1
    ``launches`` times, the capture holds ``records``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def capture(fn):
        fn()
        return 0.010, records

    monkeypatch.setattr(profiling, "_profile_call", capture)
    monkeypatch.setattr(mlp_filter_blocks_tl, "launches",
                        mlp_filter_blocks_tl.launches)

    def call():
        mlp_filter_blocks_tl.launches += launches

    return call


RECORDS = [("void mlp_filter_kernel<1>(int, int)", 100.0, 105.0),
           ("Memcpy DtoH (Device -> Pinned)", 104.0, 108.0),
           ("void at::native::elementwise_kernel<128, 4>()", 200.0, 202.0)]


def test_idle_share_from_records(monkeypatch):
    share, detail = profiling.device_idle_share(
        _fake_capture(monkeypatch, RECORDS, 1))
    assert detail["reason"] is None
    assert detail["busy_ms"] == pytest.approx(0.010)  # 8 + 2 us
    assert share == pytest.approx(1 - 0.010 / 10.0)
    assert detail["records"] == {"mlp_filter_kernel": 1, "memcpy": 1,
                                 "other": 1}
    assert detail["launches"] == {"mlp_filter_kernel": 1}


@pytest.mark.parametrize("records,launches,lost", [
    (RECORDS, 2, "mlp_filter_kernel: 1 records, 2 launches"),
    (RECORDS[1:], 1, "mlp_filter_kernel: 0 records, 1 launches"),
    (RECORDS + [("output_stage_kernel<3>", 1.0, 2.0)], 1,
     "output_stage_kernel: 1 records, 0 launches"),
])
def test_idle_share_none_when_records_disagree(monkeypatch, records,
                                               launches, lost):
    share, detail = profiling.device_idle_share(
        _fake_capture(monkeypatch, records, launches))
    assert share is None
    assert lost in detail["reason"]


def test_idle_share_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        profiling.device_idle_share(lambda: None)

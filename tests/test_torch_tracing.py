"""The port's stages as ``torch.profiler`` ranges (CPU): none without a
capture, and under one each stage a range of its name, the new stages
holding no other stage, every stage either one that
``benchmark/metrics/decode_unstaged_ms.py`` subtracts or nested in one,
and the CPPM decryptor's copies inside its decrypt inside the walk."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dvda_tpu_torch import DecodeConfig, host, open_disc
from dvda_tpu_torch.api import TrackReader
from dvda_tpu_torch.container.aob import AOBReader
from dvda_tpu_torch.cppm.decrypt import CppmDecryptor
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


@pytest.mark.parametrize("capture", ["mlp_capture", "cppm_capture"])
def test_every_stage_is_top_level_or_nested_in_one(request, capture):
    _, ranges, _ = request.getfixturevalue(capture)
    top = _top_level()
    listed = [r for r in ranges if r[2] in top]
    for r in ranges:
        held_by = [o[2] for o in listed if _inside(r, o)]
        if r[2] in top:
            assert not held_by, f"listed {r[2]} inside {held_by}"
        else:
            assert held_by, f"{r[2]} is neither listed nor inside a listed stage"


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

"""The port's PCM path on the CPU against dvda_tpu, bit-exact: kernel K8's
plain version against dvda_tpu's ``decode_chunks_device`` (jitted on the
CPU), ``decode_chunks_numpy`` and ``host.pcm_repack``; the PCM reader,
``decode_disc`` / ``disc_to_wavs`` and the port's ``dvda2wav`` against
dvda_tpu and the reference oracle."""

import os

import numpy as np
import pytest
import torch

from dvda_tpu import host
from dvda_tpu.api import DVDA as JaxDVDA
from dvda_tpu.batch import decode_disc as jax_decode_disc
from dvda_tpu.batch import disc_to_wavs as jax_disc_to_wavs
from dvda_tpu.cli import dvda2wav as jax_dvda2wav
from dvda_tpu.codecs.pcm import (chunk_size, decode_chunks_numpy,
                                 pcm_gather_indices)
from dvda_tpu.ops.pcm_unpack import decode_chunks_device as jax_unpack
from dvda_tpu_torch import DecodeConfig, api, open_disc
from dvda_tpu_torch.api import TrackReader
from dvda_tpu_torch.batch import decode_disc, disc_to_wavs
from dvda_tpu_torch.cli import dvda2wav
from dvda_tpu_torch.ops.pcm_unpack import decode_chunks_device
from dvda_tpu_torch.testutil import (MlpSynthConfig, MlpTrackSpec,
                                     PcmTrackSpec, build_disc,
                                     synth_mlp_stream)

torch.set_num_threads(1)

CPU = DecodeConfig(device="cpu")


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_unpack_matches_jax(bits, channels):
    rng = np.random.default_rng(bits * 10 + channels)
    chunks = rng.integers(0, 256, (64, chunk_size(bits, channels)),
                          dtype=np.uint8)
    got = decode_chunks_device(torch.from_numpy(chunks), bits, channels)
    assert got.dtype == torch.int32 and got.shape == (128, channels)
    assert np.array_equal(got.numpy(), decode_chunks_numpy(chunks, bits,
                                                           channels))
    assert np.array_equal(got.numpy(),
                          np.asarray(jax_unpack(chunks, bits, channels)))
    assert decode_chunks_device.launches == 0  # the CPU never counts


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("bits", [16, 24])
def test_packed_unpack_matches_pcm_repack(bits, channels):
    """``nbytes`` = bps/8: the WAV payload of dvda_tpu's PCM disc-to-WAV
    path (``pcm_repack`` with the table of ``_pcm_packed_native``)."""
    rng = np.random.default_rng(channels)
    n, nb = 50, bits // 8
    chunks = rng.integers(0, 256, (n, chunk_size(bits, channels)),
                          dtype=np.uint8)
    table = pcm_gather_indices(bits, channels)[:, :nb].reshape(-1)
    want = host.pcm_repack(chunks, table, 2 * channels * nb,
                           2 * n * channels * nb)
    got = decode_chunks_device(torch.from_numpy(chunks), bits, channels, nb)
    assert got.shape == (2 * n, channels * nb)
    assert got.numpy().tobytes() == bytes(want)


def test_unpack_empty_and_bad_arguments():
    for nbytes in (0, 3):
        out = decode_chunks_device(torch.zeros((0, 36), dtype=torch.uint8),
                                   24, 6, nbytes)
        assert out.shape == (0, 6 * (nbytes or 1))
    with pytest.raises(ValueError, match="shape"):
        decode_chunks_device(torch.zeros((4, 35), dtype=torch.uint8), 24, 6)
    with pytest.raises(ValueError, match="nbytes"):
        decode_chunks_device(torch.zeros((4, 36), dtype=torch.uint8), 24, 6,
                             4)


def _pcm_disc(tmp_path, bits, channel_assignment=17, rate=96000):
    spec = PcmTrackSpec(pcm_frames=960, seed=bits, sample_rate=rate,
                        bits_per_sample=bits,
                        channel_assignment=channel_assignment)
    return build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_pcm_reader_matches_jax(tmp_path, bits):
    layout = _pcm_disc(tmp_path, bits)
    jax_track = JaxDVDA(layout.path).open_titleset(1).open_title(1) \
        .open_track(1)
    ref = jax_track.open_reader(use_device=False).read_all()
    ref_packed = jax_track.open_reader(use_device=False).read_all_packed()
    track = open_disc(layout.path, config=CPU).open_titleset(1) \
        .open_title(1).open_track(1)
    r = track.open_reader()
    assert r.codec == "PCM" and r.bits_per_sample == bits
    assert np.array_equal(r.read_all(), ref)
    r2 = track.open_reader()
    assert r2.read_all_packed() == bytes(ref_packed)
    assert r2.total_pcm_frames == ref.shape[0] and r2.tell() == ref.shape[0]
    # the pull API on the full decode
    r3 = track.open_reader()
    assert r3.total_pcm_frames == ref.shape[0]
    assert np.array_equal(r3.read(100), ref[:100])
    assert r3.seek(500) == 500
    assert np.array_equal(r3.read(10_000), ref[500:])
    assert np.array_equal(r3.read_range(7, 9), ref[7:16])
    assert r3.manifest is None


@pytest.mark.parametrize("bits", [16, 24])
def test_pcm_reader_python_walk(tmp_path, bits):
    """``use_native_demux=False``: dvda_tpu's Python packet walk in
    ``io_batch_sectors`` batches, then K8."""
    layout = _pcm_disc(tmp_path, bits, channel_assignment=1, rate=48000)
    ref = JaxDVDA(layout.path).open_titleset(1).open_title(1) \
        .open_track(1).open_reader(use_device=False).read_all()
    cfg = DecodeConfig(device="cpu", use_native_demux=False,
                       io_batch_sectors=3)
    r = open_disc(layout.path, config=cfg).open_titleset(1).open_title(1) \
        .open_track(1).open_reader()
    assert np.array_equal(r.read_all(), ref)
    r = open_disc(layout.path, config=cfg).open_titleset(1).open_title(1) \
        .open_track(1).open_reader()
    assert r.read_all_packed() == JaxDVDA(layout.path).open_titleset(1) \
        .open_title(1).open_track(1).open_reader(use_device=False) \
        .read_all_packed()


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_pcm_walk_in_place_matches_loop_walk(tmp_path, monkeypatch, bits):
    """``read_all_packed()`` and ``read_all()`` through the native walk
    equal the Python loop's (``use_native_demux=False``).  K8 reads the
    storage the native walk wrote, counted once a decode in
    ``pcm_walks_in_place``; only the loop walk's decodes count in
    ``pcm_walks_staged``."""
    layout = _pcm_disc(tmp_path, bits)
    walked, unpacked = [], []
    walk = TrackReader._pcm_walk

    def spy_walk(self):
        out = walk(self)
        walked.append(out.data_ptr())
        return out

    def spy_unpack(chunks, *args):
        unpacked.append(chunks.data_ptr())
        return decode_chunks_device(chunks, *args)

    monkeypatch.setattr(TrackReader, "_pcm_walk", spy_walk)
    monkeypatch.setattr(api, "decode_chunks_device", spy_unpack)
    walks = TrackReader._pcm_on_device
    monkeypatch.setattr(walks, "pcm_walks_in_place", 0)
    monkeypatch.setattr(walks, "pcm_walks_staged", 0)

    def reader(**kw):
        return open_disc(layout.path, config=DecodeConfig(
            device="cpu", **kw)).open_titleset(1).open_title(1) \
            .open_track(1).open_reader()

    packed, samples = reader().read_all_packed(), reader().read_all()
    assert (walks.pcm_walks_in_place, walks.pcm_walks_staged) == (2, 0)
    assert unpacked == walked and len(walked) == 2
    loop = dict(use_native_demux=False, io_batch_sectors=3)
    assert reader(**loop).read_all_packed() == packed
    assert np.array_equal(reader(**loop).read_all(), samples)
    assert (walks.pcm_walks_in_place, walks.pcm_walks_staged) == (2, 2)
    assert len(walked) == 2 and len(unpacked) == 4 and samples.shape[0]


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_packed_output_fits_its_source(bits, channels):
    """The rule by which K8's output on the card is read back over its
    pinned source: it holds exactly where the output has its chunks'
    bytes.  So for every packed decode ``read_all_packed()`` makes (16 and
    24 bits, bps/8 bytes a sample), never for a 20-bit track's WAV bytes
    (3 a sample) and never for int32 samples (``nbytes`` 0)."""
    rng = np.random.default_rng(bits * 10 + channels)
    chunks = torch.from_numpy(rng.integers(
        0, 256, (50, chunk_size(bits, channels)), dtype=np.uint8))
    for nbytes in (0, 2, 3):
        out = decode_chunks_device(chunks, bits, channels, nbytes)
        same = out.numel() * out.element_size() == chunks.numel()
        assert api._output_fits(chunks, channels, nbytes) == (
            nbytes > 0 and same)
    wav_bytes = 3 if bits == 20 else bits // 8
    assert api._output_fits(chunks, channels, wav_bytes) == (bits != 20)


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_cpu_decode_counts_no_readback(tmp_path, monkeypatch, bits):
    """On the CPU device no decode reads back from a card: packed and
    int32 decodes, through either walk, leave both readback counters at
    0 while the walk counters see every decode."""
    layout = _pcm_disc(tmp_path, bits)
    walks = TrackReader._pcm_on_device
    for name in ("pcm_walks_in_place", "pcm_walks_staged",
                 "pcm_readbacks_pinned", "pcm_readbacks_pageable"):
        monkeypatch.setattr(walks, name, 0)
    for kw in ({}, dict(use_native_demux=False, io_batch_sectors=3)):
        track = open_disc(layout.path, config=DecodeConfig(
            device="cpu", **kw)).open_titleset(1).open_title(1) \
            .open_track(1)
        assert track.open_reader().read_all_packed()
        assert track.open_reader().read_all().shape[0]
    assert (walks.pcm_walks_in_place, walks.pcm_walks_staged) == (2, 2)
    assert (walks.pcm_readbacks_pinned, walks.pcm_readbacks_pageable) == (
        0, 0)


def _mixed_disc(tmp_path):
    """The disc of tests/test_batch.py: PCM + MLP in title 1, PCM in 2."""
    mlp = MlpSynthConfig(channel_assignment=1, n_frames=16, seed=2,
                         bits_per_sample=24, sample_rate=96000,
                         fir_across_restart=False)
    return build_disc(str(tmp_path / "AUDIO_TS"), [
        [PcmTrackSpec(pcm_frames=960, seed=1),
         MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                      pcm_frames=mlp.total_pcm_frames,
                      sample_rate=96000, channel_assignment=1)],
        [PcmTrackSpec(pcm_frames=480, seed=9)],
    ])


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
@pytest.mark.parametrize("packed", [False, True])
def test_decode_disc_matches_jax(tmp_path, packed):
    layout = _mixed_disc(tmp_path)
    got = list(decode_disc(layout.path, config=CPU, packed=packed))
    ref = list(jax_decode_disc(layout.path, use_device=False,
                               packed=packed))
    assert [(r.title, r.track, r.codec) for r in got] == [
        (1, 1, "PCM"), (1, 2, "MLP"), (2, 1, "PCM")]
    for g, r in zip(got, ref):
        assert (g.titleset, g.title, g.track, g.codec, g.sample_rate,
                g.bits_per_sample, g.channel_count, g.channel_mask,
                g.pcm_frames) == (r.titleset, r.title, r.track, r.codec,
                                  r.sample_rate, r.bits_per_sample,
                                  r.channel_count, r.channel_mask,
                                  r.pcm_frames)
        assert g.wav_data() == bytes(r.wav_data())
        if not packed:
            assert np.array_equal(g.samples, r.samples)


def _same_files(dir_a, dir_b, names=None):
    names = sorted(os.listdir(dir_b)) if names is None else names
    assert sorted(os.listdir(dir_a)) == names
    for name in names:
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
def test_disc_to_wavs_matches_jax(tmp_path):
    layout = _mixed_disc(tmp_path)
    jax_disc_to_wavs(layout.path, str(tmp_path / "jax"), use_device=False)
    written = disc_to_wavs(layout.path, str(tmp_path / "ours"), config=CPU)
    assert len(written) == 3
    _same_files(str(tmp_path / "ours"), str(tmp_path / "jax"))


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
def test_disc_to_wavs_matches_oracle(tmp_path, ref_oracle):
    layout = _mixed_disc(tmp_path)
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    written = disc_to_wavs(layout.path, str(tmp_path / "ours"), config=CPU)
    assert sorted(os.path.basename(p) for p in written) == sorted(golden)
    for p in written:
        with open(p, "rb") as f:
            assert f.read() == golden[os.path.basename(p)], p


def _cli_disc(tmp_path):
    """The disc of tests/test_cli.py: PCM 16 + MLP 5.1, then PCM 24."""
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         bits_per_sample=24, sample_rate=96000,
                         n_frames=24, seed=4, fir_across_restart=False)
    return build_disc(str(tmp_path / "AUDIO_TS"), [
        [PcmTrackSpec(pcm_frames=960, seed=1),
         MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                      pcm_frames=mlp.total_pcm_frames,
                      sample_rate=96000, channel_assignment=17)],
        [PcmTrackSpec(pcm_frames=480, seed=2, bits_per_sample=24)],
    ])


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
def test_dvda2wav_matches_jax(tmp_path, capsys):
    """Same files, bytes and status lines as dvda_tpu's dvda2wav."""
    layout = _cli_disc(tmp_path)
    jax_dir, our_dir = str(tmp_path / "jax"), str(tmp_path / "ours")
    assert jax_dvda2wav.main(["-A", layout.path, "-d", jax_dir,
                              "--no-device"]) == 0
    want = capsys.readouterr().out.replace(jax_dir, our_dir)
    assert dvda2wav.main(["-A", layout.path, "-d", our_dir,
                          "--no-device"]) == 0
    assert capsys.readouterr().out == want
    _same_files(our_dir, jax_dir)
    assert dvda2wav.main(["-A", layout.path, "-d", str(tmp_path / "sel"),
                          "-T", "1", "-t", "2", "--no-device"]) == 0
    _same_files(str(tmp_path / "sel"), jax_dir, ["track-01-02.wav"])
    assert dvda2wav.main(["-A", "/nonexistent"]) == 1
    capsys.readouterr()
    stream_dir = str(tmp_path / "stream")
    assert jax_dvda2wav.main(["-A", layout.path, "-d", jax_dir,
                              "--no-device", "--stream"]) == 0
    want = capsys.readouterr().out.replace(jax_dir, stream_dir)
    assert dvda2wav.main(["-A", layout.path, "-d", stream_dir,
                          "--no-device", "--stream"]) == 0
    assert capsys.readouterr().out == want
    _same_files(stream_dir, jax_dir)


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
def test_dvda2wav_matches_reference(tmp_path, ref_oracle, capsys):
    layout = _cli_disc(tmp_path)
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    out_dir = str(tmp_path / "ours")
    assert dvda2wav.main(["-A", layout.path, "-d", out_dir,
                          "--no-device"]) == 0
    assert sorted(os.listdir(out_dir)) == sorted(golden)
    for name in golden:
        with open(os.path.join(out_dir, name), "rb") as f:
            assert f.read() == golden[name], name
    out = capsys.readouterr().out
    assert "* Extracting PCM track  2 channels  48000 Hz  16 bps" in out
    assert "* Extracting MLP track  6 channels  96000 Hz  24 bps" in out
    assert f'* Wrote: "{os.path.join(out_dir, "track-02-01.wav")}"' in out


@pytest.mark.skipif(not host.available(),
                    reason="native host library unavailable")
def test_dvda2wav_selection_matches_reference(tmp_path, ref_oracle):
    layout = _cli_disc(tmp_path)
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"),
                                     title=1, track=2)
    out_dir = str(tmp_path / "ours")
    assert dvda2wav.main(["-A", layout.path, "-d", out_dir, "-T", "1",
                          "-t", "2", "--no-device"]) == 0
    assert sorted(os.listdir(out_dir)) == ["track-01-02.wav"]
    with open(os.path.join(out_dir, "track-01-02.wav"), "rb") as f:
        assert f.read() == golden["track-01-02.wav"]

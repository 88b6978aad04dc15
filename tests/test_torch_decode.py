"""The port's whole MLP decode on the CPU (plain versions of K1 and K234)
against dvda_tpu's device pipeline (``host_complete=False``, jitted on the
CPU), at stream, reader and reference-oracle level, and at reader level
against the benchmark's plain reference decoder.  Bit-exact."""

import numpy as np
import pytest
import torch

from dvda_tpu import host
from dvda_tpu.api import DVDA
from dvda_tpu.codecs.mlp import native_engine as ne
from dvda_tpu.codecs.params import StreamParameters
from dvda_tpu.config import DecodeConfig as JaxConfig
from dvda_tpu.utils.wav import wave_header
from benchmark.fmt.params import StreamParameters as PlainParameters
from benchmark.reference.expected import pack_le
from benchmark.reference.mlp_spec import MlpDecoder
from dvda_tpu_torch import DecodeConfig, open_disc
from dvda_tpu_torch import host as port_host
from dvda_tpu_torch.codecs.mlp.native_engine import (_Drain,
                                                     decode_host_complete,
                                                     decode_native)
from dvda_tpu_torch.testutil import (BPS_CODE, RATE_CODE, MlpSynthConfig,
                                     MlpTrackSpec, build_disc,
                                     synth_mlp_stream)

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")

torch.set_num_threads(1)

UNIFORM = dict(fir_across_restart=False, params_update_prob=0.0)
FIVE_ONE = dict(channel_assignment=17, substream_count=2)
#: output shifts of 6-7 bits: 24-bit samples past the 12-bit pair tier and
#: int16, so the narrow readback runs its first chunks again, wide
LOUD = (6, 8)
#: MLP 2.0/192k/24 at a small size of the benchmark's ``mlp20_192k24``: one
#: substream, 2 blocks of 80 samples a frame, a restart every 8 frames
#: (chains of 1,280 samples), parameter updates, loud
STEREO_192K = dict(channel_assignment=1, sample_rate=192000,
                   block_size=80, n_frames=64, fir_across_restart=False,
                   out_shift_range=LOUD)
STREAMS = {
    "stereo": dict(channel_assignment=1, n_frames=40, restart_every=4,
                   major_sync_every=4, seed=1, **UNIFORM),
    "5.1_96k": dict(sample_rate=96000, n_frames=48, seed=2, **FIVE_ONE,
                    **UNIFORM),
    "16bit": dict(channel_assignment=1, bits_per_sample=16,
                  sample_rate=48000, n_frames=40, restart_every=4,
                  major_sync_every=4, seed=3, **UNIFORM),
    "param_updates": dict(n_frames=40, restart_every=4, major_sync_every=4,
                          seed=12, fir_across_restart=False,
                          params_update_prob=0.4, **FIVE_ONE),
    "2.0_192k": dict(seed=13, **STEREO_192K),
}


def stream_params(cfg):
    return StreamParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                            RATE_CODE[cfg.sample_rate], 0xF,
                            cfg.channel_assignment)


def both(stream, params, want_packed=False, chunk_chains=256):
    """(port, dvda_tpu) decodes of one stream, plus the port's info."""
    bnd = np.zeros(0, np.int64)
    info = {}
    got = decode_native(stream, bnd, len(stream), params, want_packed,
                        DecodeConfig(device="cpu", chunk_chains=chunk_chains),
                        info=info)
    ref = ne.decode_native(stream, bnd, len(stream), params, want_packed,
                           JaxConfig(host_complete=False,
                                     chunk_chains=chunk_chains))
    return got, ref, info


@pytest.mark.parametrize("chunk_chains", [2, 256])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decode_native_matches_jax(name, chunk_chains):
    cfg = MlpSynthConfig(**STREAMS[name])
    stream = synth_mlp_stream(cfg)
    params = stream_params(cfg)
    want_packed = name != "stereo"
    got, ref, info = both(stream, params, want_packed, chunk_chains)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert info["chunks"] >= (2 if chunk_chains == 2 else 1)
    if cfg.out_shift_range == LOUD:
        assert info["path"] == "pipelined" and info["redone"] >= 1
    hc = decode_host_complete(stream, np.zeros(0, np.int64), len(stream),
                              params, want_packed)
    assert np.array_equal(got, hc)


def test_sectioned_streams_match_jax():
    """A block-size switch mid-stream and coupled restarts (FIR state
    carried across restarts): both stay on the pipelined path as two
    uniform sections each, in both packages."""
    c1 = MlpSynthConfig(blocks_per_frame=2, block_size=32, n_frames=8,
                        seed=11, **FIVE_ONE)
    c2 = MlpSynthConfig(blocks_per_frame=2, block_size=64, n_frames=8,
                        seed=12, **FIVE_ONE)
    coupled = MlpSynthConfig(restart_every=2, major_sync_every=2,
                             n_frames=16, seed=7, **FIVE_ONE)
    for stream in (synth_mlp_stream(c1) + synth_mlp_stream(c2),
                   synth_mlp_stream(coupled)):
        got, ref, info = both(stream, stream_params(c1))
        assert np.array_equal(got, ref)
        assert info["sections"] == ne._LAST_PIPELINE_INFO["sections"] == 2


def test_geometry_churn_raises():
    """More than 8 geometry sections: dvda_tpu abandons the stream to its
    general gather path, and so does the port (K6a, K1, K6b); the two
    decodes are bit-identical.  (The name dates from when the port raised
    on such streams; it is kept so that the test keeps its identity.)"""
    stream = b"".join(synth_mlp_stream(MlpSynthConfig(
        blocks_per_frame=2, block_size=64 if i % 2 == 0 else 32, n_frames=4,
        seed=30 + i, **FIVE_ONE)) for i in range(10))
    params = stream_params(MlpSynthConfig(**FIVE_ONE))
    got, ref, info = both(stream, params)
    assert info["path"] == "general"
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


#: streams over the 64 KiB where ``mlp_parse_begin_mt`` cuts the stream
#: into sections (host/src/mlp_parse.cc), so a parse with threads runs
#: its workers and its merger thread: the uniform 5.1/96k stream (72,730
#: bytes) and the ``param_updates`` recipe (81,810 bytes), 320 frames each
THREADED = {"5.1_96k": dict(STREAMS["5.1_96k"], n_frames=320),
            "param_updates": dict(STREAMS["param_updates"], n_frames=320)}
#: frame 176 of the uniform stream (byte 40,000) opens a section at both
#: thread counts below (8 and 20 byte-balanced sections): flipping bits in
#: it drops the frame, and the section is repaired by a local reparse
DAMAGED_FRAME = 176


@pytest.mark.parametrize("threads", [2, 8])
@pytest.mark.parametrize("name,huffman,damaged", [
    ("5.1_96k", False, False), ("5.1_96k", True, False),
    ("param_updates", False, False), ("5.1_96k", False, True)])
def test_threaded_parse_decode_matches_jax(monkeypatch, name, huffman,
                                           damaged, threads):
    """A whole decode on the multi-threaded parse: the port's bytes equal
    dvda_tpu's host-complete decode, and the merger thread took sections
    in.  Every section is taken in once, by the merger or on the decode's
    thread, so ``merged_ahead + merged_inline == parse_sections``."""
    cfg = MlpSynthConfig(**THREADED[name])
    stream = synth_mlp_stream(cfg)
    assert len(stream) >= 64 << 10
    if damaged:
        at = int(port_host.parse_mlp_stream(stream)
                 .frame_end[DAMAGED_FRAME - 1])
        data = bytearray(stream)
        for k in (10, 40, 70):
            data[at + k] ^= 0x10
        stream = bytes(data)
    stats = []
    close = port_host.IncrementalParse.close

    def spy(inc):
        if inc._h is not None:
            stats.append((inc.merge_stats(), inc.mt_stats))
        close(inc)

    monkeypatch.setattr(port_host.IncrementalParse, "close", spy)
    params, bnd = stream_params(cfg), np.zeros(0, np.int64)
    extra = dict(device_huffman=True, huffman_split=8) if huffman else {}
    got = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cpu", parse_threads=threads,
                                     chunk_chains=4, **extra))
    ref = ne.decode_native(stream, bnd, len(stream), params, True,
                           JaxConfig(host_complete=True))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert len(stats) == 1, stats
    merge, (repairs, redos) = stats[0]
    assert merge["parse_sections"] > 1 and merge["merged_ahead"] > 0
    assert merge["merged_ahead"] + merge["merged_inline"] \
        == merge["parse_sections"], merge
    assert (repairs, redos) == ((1, 0) if damaged else (0, 0))


def test_chunk_rule_counts_chains():
    """A chunk holds ``chunk_chains`` restart chains scaled by 6/out_ch,
    whatever a chain's length: 256 at 6 channels (640-sample chains at
    5.1/96k), 768 at 2 channels (1,280-sample chains at 2.0/192k).  The
    pipelined decode of the 2.0/192k stream's 8 chains takes chunks of 6
    chains at ``chunk_chains=2``, as dvda_tpu's does."""
    cfg = DecodeConfig()
    assert cfg.resolved_chunk_chains(6) == cfg.resolved_chunk_chains() == 256
    assert cfg.resolved_chunk_chains(2) == 768
    c = MlpSynthConfig(**STREAMS["2.0_192k"])
    got, ref, info = both(synth_mlp_stream(c), stream_params(c), True, 2)
    assert np.array_equal(got, ref)
    assert (info["path"], info["sections"], info["chunks"]) == (
        "pipelined", 1, 2)


#: the reader discs: the 5.1/96k track, and the loud 2.0/192k/24 one
DISCS = {"5.1_96k": dict(sample_rate=96000, n_frames=48, **FIVE_ONE,
                         **UNIFORM),
         "2.0_192k": STEREO_192K}


def _disc(tmp_path, seeds=(5,), kind="5.1_96k"):
    cfgs = [MlpSynthConfig(seed=s, **DISCS[kind]) for s in seeds]
    tracks = [MlpTrackSpec(mlp_stream=synth_mlp_stream(c),
                           pcm_frames=c.total_pcm_frames,
                           sample_rate=c.sample_rate,
                           channel_assignment=c.channel_assignment)
              for c in cfgs]
    return build_disc(str(tmp_path / "AUDIO_TS"), [tracks]), cfgs


def _plain_wav(cfg) -> bytes:
    """The WAV bytes of ``cfg``'s stream by the benchmark's plain
    reference decoder (``benchmark/reference/mlp_spec.py``)."""
    dec = MlpDecoder(PlainParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                                     RATE_CODE[cfg.sample_rate], 0xF,
                                     cfg.channel_assignment))
    dec.decode_bytes(synth_mlp_stream(cfg))
    return pack_le(dec.take_frames(), cfg.bits_per_sample).tobytes()


def _reader(path, n, config):
    return (open_disc(path, config=config).open_titleset(1).open_title(1)
            .open_track(n).open_reader())


@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("kind", sorted(DISCS))
def test_reader_matches_jax(tmp_path, kind, narrow):
    """``read_all_packed`` and ``read_all`` equal dvda_tpu's, and the
    packed bytes the plain reference decoder's, with the narrow readback
    on and off.  Both tracks take the pipelined path in one section; the
    loud 2.0/192k track, read back narrow, runs a chunk again."""
    layout, (cfg,) = _disc(tmp_path, kind=kind)
    cpu = DecodeConfig(device="cpu", narrow_d2h=narrow)
    jax_track = DVDA(layout.path).open_titleset(1).open_title(1).open_track(1)
    jcfg = JaxConfig(host_complete=False)
    reader = _reader(layout.path, 1, cpu)
    packed = reader.read_all_packed()
    assert packed == jax_track.open_reader(config=jcfg).read_all_packed()
    assert packed == _plain_wav(cfg)
    info = reader.decode_info
    assert (info["path"], info["sections"]) == ("pipelined", 1)
    if cfg.out_shift_range == LOUD:
        assert (info["tier"], info["redone"] >= 1) == (0, narrow)
    samples = _reader(layout.path, 1, cpu).read_all()
    assert np.array_equal(samples,
                          jax_track.open_reader(config=jcfg).read_all())


def test_reader_matches_reference_oracle(tmp_path, ref_oracle):
    """Multi-track disc (probe, packet boundaries, tail-to-sync rule)
    against the reference dvda2wav's WAV files."""
    layout, _ = _disc(tmp_path, seeds=(1, 2))
    golden = ref_oracle.run_dvda2wav(layout.path, str(tmp_path / "gold"))
    for n in (1, 2):
        reader = _reader(layout.path, n, DecodeConfig(device="cpu"))
        data = reader.read_all_packed()
        hdr = wave_header(reader.sample_rate, reader.channel_count,
                          reader.channel_mask, reader.bits_per_sample,
                          len(data) // (reader.channel_count * 3))
        assert hdr + data == golden[f"track-01-{n:02d}.wav"], f"track {n}"


@pytest.fixture(scope="module")
def range_discs(tmp_path_factory):
    from test_torch_pcm import _pcm_disc

    return {"mlp": _disc(tmp_path_factory.mktemp("mlp"))[0].path,
            "pcm16": _pcm_disc(tmp_path_factory.mktemp("pcm"), 16).path}


_RANGE_STATES = {"fresh": lambda r: None, "read4": lambda r: r.read(4),
                 "seek10": lambda r: r.seek(10),
                 "read_all": lambda r: r.read_all()}


@pytest.mark.parametrize("start,n", [(-10, 3), (-3, 5), (-10, 30), (7, 9),
                                     (5, -2), ("len-5", 100)])
@pytest.mark.parametrize("state", sorted(_RANGE_STATES))
@pytest.mark.parametrize("disc", ["mlp", "pcm16"])
def test_read_range_matches_jax(range_discs, disc, state, start, n):
    """``read_range`` gives dvda_tpu's frames on a fresh reader and after
    ``read``, ``seek`` and ``read_all``: clamped to the track where
    dvda_tpu's MLP segment reader serves it, the Python slice (a negative
    start counting from the end) everywhere else."""
    path = range_discs[disc]
    jax_reader = DVDA(path).open_titleset(1).open_title(1).open_track(1) \
        .open_reader(config=JaxConfig(host_complete=True))
    reader = _reader(path, 1, DecodeConfig(device="cpu"))
    total = reader.total_pcm_frames
    assert total == jax_reader.total_pcm_frames > 100
    if start == "len-5":
        start = total - 5
    for r in (jax_reader, reader):
        _RANGE_STATES[state](r)
    got = reader.read_range(start, n)
    want = jax_reader.read_range(start, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert reader.tell() == jax_reader.tell()


def test_drain_grows_and_zero_fills():
    """The output buffer grows when pushes outrun its estimate, keeps the
    rows already drained, and zero-fills rows that were never pushed."""
    drain = _Drain(torch.device("cpu"), 3, torch.uint8, capacity=1)
    rng = np.random.default_rng(0)
    chunks = [torch.from_numpy(rng.integers(0, 256, (n + 4, 3))
                               .astype(np.uint8)) for n in (5, 2, 9)]
    for c in chunks:
        drain.push(c, c.shape[0] - 4)  # padding rows are not drained
    want = np.concatenate([c[:-4].numpy() for c in chunks])
    out = drain.finish(want.shape[0] + 2)
    assert np.array_equal(out[: want.shape[0]], want)
    assert not out[want.shape[0]:].any()

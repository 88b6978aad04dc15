"""The port's copy of the C++ host library (dvda_tpu_torch/host) against
dvda_tpu's (dvda_tpu/host) on synthetic streams and discs: parse arrays
in full and skip-values mode, ``mp_pack`` arenas, ``mp_reconstruct``
bytes, the MLP and PCM demux, host C2 and ``pcm_repack``.  Identical
arrays and bytes.  Also the port's multi-threaded parse, whose merger
thread merges sections off the caller's thread, against dvda_tpu's
sequential parse: its output, the views it leaves valid, its counters,
the sections it hands back and its teardown."""

import os
import random
import threading
import time

import numpy as np
import pytest

from dvda_tpu import host as jax_host
from dvda_tpu.container.aob import AOBReader as JaxAOBReader
from dvda_tpu_torch import host
from dvda_tpu_torch.codecs.mlp import native_engine as pe
from dvda_tpu_torch.codecs.params import PTS_PER_SECOND
from dvda_tpu_torch.codecs.pcm import chunk_size, pcm_gather_indices
from dvda_tpu_torch.container.aob import AOBReader
from dvda_tpu_torch.testutil import (MlpSynthConfig, MlpTrackSpec,
                                     PcmTrackSpec, build_disc,
                                     encrypt_sectors_batch, synth_mlp_stream)

pytestmark = pytest.mark.skipif(
    not (host.available() and jax_host.available()),
    reason="native host library unavailable")

KEYS = (0x00DEADBEEF001122, 0x0F0E0D0C0B0A0908)
SYNTH = dict(channel_assignment=17, substream_count=2, sample_rate=96000,
             n_frames=40, restart_every=4, major_sync_every=4, seed=12,
             fir_across_restart=False, params_update_prob=0.4)
_FRAME_KEYS = ("F", "T", "substream_count", "mmc", "assignment", "status",
               "skip_values", "frame_len", "frame_end", "out_shift",
               "mat_active", "mat_out", "mat_quant", "mat_coeff", "mat_noise",
               "frame_seed", "frame_nshift", "bypassed_packed")


def _stream():
    return synth_mlp_stream(MlpSynthConfig(**SYNTH))


def _parses(stream, **kw):
    a = host.parse_mlp_stream_begin(stream, **kw)
    b = jax_host.parse_mlp_stream_begin(stream, **kw)
    a.step(0)
    b.step(0)
    return a, b


def _equal(x, y):
    if isinstance(x, np.ndarray):
        return x.dtype == y.dtype and np.array_equal(x, y)
    return x == y


@pytest.mark.parametrize("kw", [dict(), dict(threads=3),
                                dict(skip_values=True),
                                dict(skip_values=True, sub_every=8)])
def test_parse_arrays_identical(kw):
    a, b = _parses(_stream(), **kw)
    try:
        va, vb = a.view(), b.view()
        assert va.status == 0 and va.F > 0
        for k in _FRAME_KEYS:
            assert _equal(getattr(va, k), getattr(vb, k)), k
        if not kw.get("skip_values"):
            assert _equal(va.noise0, vb.noise0)
            assert _equal(va.noise1, vb.noise1)
        for sa, sb in zip(va.sub, vb.sub, strict=True):
            assert sorted(sa) == sorted(sb)
            for k in sa:
                assert _equal(sa[k], sb[k]), k
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("huffman", [False, True])
def test_mp_pack_arenas_identical(huffman):
    """The port's arena builder over each library's parse: the same
    ``mp_pack`` instructions give the same three arenas and spec."""
    a, b = _parses(_stream(), skip_values=huffman)
    try:
        outs = []
        for v in (a.view(), b.view()):
            subs = [(v.sub[s], 0, 40, 8, 0) for s in range(2)]
            outs.append(pe._build_chunk_arenas(
                v, subs, 0, 4, 4, 320, 40, 6, 24, 0, 0, 6, huffman=huffman))
        (ar_a, spec_a), (ar_b, spec_b) = outs
        assert spec_a == spec_b
        for x, y in zip(ar_a, ar_b):
            assert _equal(x, y) and x.any()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("pack_bits", [0, 16, 24])
def test_mp_reconstruct_identical(pack_bits):
    a, b = _parses(_stream(), threads=2)
    try:
        va, vb = a.view(), b.view()
        perm = pe._wave_perm(va, 6)
        got = va.reconstruct(va.F, 6, pack_bits, perm, threads=2)
        want = vb.reconstruct(vb.F, 6, pack_bits, perm, threads=2)
        assert _equal(got, want) and got.any()
    finally:
        a.close()
        b.close()


@pytest.fixture(scope="module")
def disc(tmp_path_factory):
    mlp = MlpSynthConfig(**dict(SYNTH, params_update_prob=0.0))
    return build_disc(str(tmp_path_factory.mktemp("host") / "AUDIO_TS"), [[
        PcmTrackSpec(pcm_frames=960, seed=8, sample_rate=96000,
                     bits_per_sample=24, channel_assignment=17),
        MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                     pcm_frames=mlp.total_pcm_frames, sample_rate=96000,
                     channel_assignment=17),
        PcmTrackSpec(pcm_frames=1920, seed=1)]])


def _spans(path, tracks=(1, 2, 3)):
    import dvda_tpu_torch

    title = (dvda_tpu_torch.open_disc(path, config=dvda_tpu_torch.
                                      DecodeConfig(device="cpu"))
             .open_titleset(1).open_title(1))
    return [title.open_track(n).open_reader() for n in tracks]


def test_demux_identical(disc):
    """MLP stream assembly, batch by batch (the PCM packet walk:
    ``test_pcm_walk_identical``)."""
    readers = _spans(disc.path)
    span = readers[1].track.span
    for batch in (4096, 3):
        got = host.assemble_mlp_stream(AOBReader(disc.path, 1),
                                       span.first_sector, span.last_sector,
                                       batch)
        want = jax_host.assemble_mlp_stream(JaxAOBReader(disc.path, 1),
                                            span.first_sector,
                                            span.last_sector, batch)
        assert got[0] == want[0] and len(got[0]) > 0
        assert _equal(got[1], want[1]) and got[2] == want[2]


@pytest.fixture(scope="module")
def pcm_pair_disc(tmp_path_factory):
    """Two PCM tracks of different parameters, back to back: a walk past
    the first track's end stops at the parameter change."""
    return build_disc(str(tmp_path_factory.mktemp("pcm2") / "AUDIO_TS"), [[
        PcmTrackSpec(pcm_frames=1920, seed=3),
        PcmTrackSpec(pcm_frames=960, seed=4, sample_rate=96000,
                     bits_per_sample=24, channel_assignment=17)]])


@pytest.mark.parametrize("total", ["past", "track", 1, 0])
@pytest.mark.parametrize("batch", [4096, 5, 1])
@pytest.mark.parametrize("walk", ["codec_change", "aob_end",
                                  "parameter_change"])
def test_pcm_walk_identical(disc, pcm_pair_disc, walk, batch, total):
    """The in-place PCM packet walk into a destination of exactly
    ``pcm_walk_capacity`` bytes against dvda_tpu's ``assemble_pcm_chunks``:
    a PCM track followed by an MLP one (the walk ends on the codec
    change), the disc's last track (the walk ends with the AOB) and a PCM
    track followed by one of other parameters; a countdown past the
    track's end, exactly the track, 1 frame and 0 (one packet).  The bytes
    past the written count stay as they were; one chunk less room, or a
    read-only destination, raises."""
    path, n = {"codec_change": (disc.path, 1), "aob_end": (disc.path, 3),
               "parameter_change": (pcm_pair_disc.path, 1)}[walk]
    r, = _spans(path, (n,))
    p, first = r.parameters, r.track.span.first_sector
    csize = chunk_size(p.bits_per_sample, p.channel_count)
    frames = round(r.track.span.pts_length * p.sample_rate
                   / PTS_PER_SECOND)  # the track's countdown
    count = {"past": p.sample_rate, "track": frames}.get(total, total)
    cap = host.pcm_walk_capacity(AOBReader(path, 1), first, count, csize)
    dest = np.full(cap + 64, 0xA5, dtype=np.uint8)
    got = host.walk_pcm_chunks(AOBReader(path, 1), first, p, count, csize,
                               dest[:cap], batch)
    want = jax_host.assemble_pcm_chunks(JaxAOBReader(path, 1), first, p,
                                        count, csize, batch)
    assert dest[:got].tobytes() == want and got % csize == 0
    assert got >= csize and (dest[got:] == 0xA5).all()
    assert host.assemble_pcm_chunks(AOBReader(path, 1), first, p, count,
                                    csize, batch) == want
    if total == "past" and walk != "aob_end":
        assert got == frames // 2 * csize  # stopped at the change
    with pytest.raises(RuntimeError, match="past the destination"):
        host.walk_pcm_chunks(AOBReader(path, 1), first, p, count, csize,
                             np.empty(got - csize, dtype=np.uint8), batch)
    with pytest.raises(ValueError, match="writable C-contiguous"):
        host.walk_pcm_chunks(AOBReader(path, 1), first, p, count, csize,
                             np.frombuffer(bytes(cap), np.uint8), batch)


@pytest.mark.parametrize("preserve_cci", [False, True])
def test_c2_decrypt_identical(disc, preserve_cci):
    raw = np.fromfile(os.path.join(disc.path, "ATS_01_1.AOB"),
                      dtype=np.uint8).reshape(-1, 2048)
    enc = encrypt_sectors_batch(raw, *KEYS)
    got, want = enc.copy(), enc.copy()
    n = host.c2_decrypt_sectors(got, *KEYS, preserve_cci)
    assert n == jax_host.c2_decrypt_sectors(want, *KEYS, preserve_cci) > 0
    assert _equal(got, want) and not np.array_equal(got, enc)


@pytest.mark.parametrize("bits,channels", [(16, 2), (24, 6), (20, 3)])
def test_pcm_repack_identical(bits, channels):
    rng = np.random.default_rng(bits + channels)
    chunks = rng.integers(0, 256, (37, chunk_size(bits, channels)),
                          dtype=np.uint8)
    nb = (bits + 7) // 8
    table = pcm_gather_indices(bits, channels)[:, :nb].reshape(-1)
    per = 2 * channels * nb
    for max_bytes in (37 * per, 37 * per + 11):
        got = host.pcm_repack(chunks, table, per, max_bytes)
        want = jax_host.pcm_repack(chunks, table, per, max_bytes)
        assert bytes(got) == bytes(want) and len(got) == max_bytes


# ---- the multi-threaded parse's merger thread ------------------------------

MT_SYNTH = dict(channel_assignment=17, substream_count=2, sample_rate=96000,
                n_frames=600, seed=7, major_sync_every=4, restart_every=4,
                blocks_per_frame=2, block_size=40)


def _mt_stream(**kw):
    stream = synth_mlp_stream(MlpSynthConfig(**dict(MT_SYNTH, **kw)))
    assert len(stream) > 64 << 10  # below this the MT path won't engage
    return stream


def _frame_starts(stream):
    starts, off = [], 0
    while off + 4 <= len(stream):
        total = (((stream[off] & 0x0F) << 8) | stream[off + 1]) * 2
        if total < 4 or off + total > len(stream):
            break
        starts.append(off)
        off += total
    return starts


def _damaged(stream, frames, at=40):
    data = bytearray(stream)
    for fi in frames:
        data[_frame_starts(stream)[fi] + at] ^= 0x5A
    return bytes(data)


def _arrays(v, noise=True):
    """Every array and scalar of a parse view, arrays copied."""
    if v.status != 0:
        return {"status": v.status, "bail_reason": v.bail_reason}
    got = {k: getattr(v, k) for k in _FRAME_KEYS}
    if noise and not v.skip_values:
        got.update(noise0=v.noise0, noise1=v.noise1)
    for s, sub in enumerate(v.sub):
        got.update({f"{s}.{k}": x for k, x in sub.items()})
    return {k: np.array(x) if isinstance(x, np.ndarray) else x
            for k, x in got.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _equal(got[k], want[k]), k


def _reference(stream, **kw):
    """The arrays of dvda_tpu's sequential parse."""
    inc = jax_host.parse_mlp_stream_begin(stream, threads=1, **kw)
    try:
        inc.step(0)
        return _arrays(inc.view())
    finally:
        inc.close()


def _parse(stream, threads, **kw):
    """(arrays, merge_stats, mt_stats) of the port's parse stepped to its
    end."""
    inc = host.parse_mlp_stream_begin(stream, threads=threads, **kw)
    try:
        assert inc.step(0) is False
        return _arrays(inc.view()), inc.merge_stats(), inc.mt_stats
    finally:
        inc.close()


@pytest.mark.parametrize("kw", [dict(), dict(skip_values=True, sub_every=8)],
                         ids=["values", "skip"])
@pytest.mark.parametrize("threads", [2, 3, 8])
def test_mt_merge_bit_identical(threads, kw):
    """The merger's parse == dvda_tpu's sequential parse, array for array,
    on a stream of 8 sections or more, as is the port's sequential one."""
    stream = _mt_stream()
    want = _reference(stream, **kw)
    seq_got, seq, _ = _parse(stream, 1, **kw)
    got, stats, _ = _parse(stream, threads, **kw)
    assert seq == dict(merged_ahead=0, merged_inline=0, step_waits=0,
                       parse_sections=0, flushed_ahead=0)
    assert stats["parse_sections"] >= 8
    assert stats["merged_ahead"] == stats["parse_sections"]
    _assert_same(seq_got, want)
    _assert_same(got, want)


def test_mt_merge_views_stay_valid():
    """Views taken after a step read the same values after the merger has
    merged the rest, and those values are the final arrays' prefix."""
    inc = host.parse_mlp_stream_begin(_mt_stream(), threads=4)
    try:
        held, more = [], True
        while more and len(held) < 3:  # the merger may finish any time
            more = inc.step(64)
            v = inc.view()
            held.append((v, _arrays(v, noise=False)))
        assert inc.step(0) is False
        final = _arrays(inc.view(), noise=False)
        assert inc.merge_stats()["merged_inline"] == 0
        assert 0 < held[0][1]["F"] <= final["F"]
        for v, was in held:
            _assert_same(_arrays(v, noise=False), was)
            for k, x in was.items():
                if isinstance(x, np.ndarray):
                    assert _equal(x, final[k][:len(x)]), k
    finally:
        inc.close()


def test_mt_merge_runs_ahead():
    """Given time before the steps, the merger merges every section, and
    the steps find them merged and never wait."""
    inc = host.parse_mlp_stream_begin(_mt_stream(), threads=4)
    try:
        deadline = time.monotonic() + 60
        while True:
            stats = inc.merge_stats()
            if (stats["flushed_ahead"] == stats["parse_sections"]
                    or time.monotonic() > deadline):
                break
            time.sleep(0.01)
        assert stats["flushed_ahead"] == stats["parse_sections"] >= 8
        while inc.step(64):
            pass
        stats = inc.merge_stats()
        assert stats["merged_ahead"] == stats["parse_sections"]
        assert stats["merged_inline"] == 0 and stats["step_waits"] == 0
    finally:
        inc.close()


def _entry_sweep():
    """One damaged frame at a time across the stream: mid-section drops
    need nothing, section-entry drops a local repair on the caller's
    thread."""
    base = _mt_stream()
    n = len(_frame_starts(base))
    for fi in range(3, n - 3, 13):
        yield _damaged(base, [fi]), dict(full_redo=0, max_repairs=1)


def _entry_bursts():
    """Ten damaged frames in a burst: consecutive sections' entries."""
    base = _mt_stream()
    n = len(_frame_starts(base))
    for fi in range(3, n - 40, 37):
        yield _damaged(base, range(fi, fi + 40, 4)), dict(full_redo=0)


def _random_damage():
    """The random corruption sweep of tests/test_fuzz.py."""
    rng = random.Random(303)
    base = synth_mlp_stream(MlpSynthConfig(
        channel_assignment=17, substream_count=2, n_frames=400, seed=31,
        major_sync_every=4, restart_every=4, blocks_per_frame=2,
        block_size=40))
    for _ in range(10):
        data = bytearray(base)
        for _ in range(rng.randrange(1, 4)):
            data[rng.randrange(len(data))] ^= rng.randrange(1, 256)
        yield bytes(data), {}


def _bail_stream():
    """No check data and one damaged frame mid-stream: the substreams'
    frame lengths disagree and the parse bails there."""
    return _damaged(_mt_stream(checkdata=False), [302], at=174)


def _mid_bail():
    yield _bail_stream(), dict(full_redo=0, status=1)


def _denser_tail():
    """Large blocks, then small ones: the first section's projection
    leaves later sections past the reserved capacity."""
    def part(block_size, blocks_per_frame, seed):
        return synth_mlp_stream(MlpSynthConfig(**dict(
            MT_SYNTH, n_frames=300, seed=seed, block_size=block_size,
            blocks_per_frame=blocks_per_frame, end_marker=False)))
    yield part(160, 1, 3) + part(8, 8, 4), dict(full_redo=0, max_repairs=0)


@pytest.mark.parametrize("case", [_entry_sweep, _entry_bursts, _random_damage,
                                  _mid_bail, _denser_tail],
                         ids=lambda f: f.__name__.strip("_"))
def test_mt_merge_handed_back_matches_sequential(case):
    """Damaged and uneven streams, whose sections the merger hands back
    to ``step`` (a repair, a bail, a section past the reserved capacity):
    the parse still equals dvda_tpu's sequential one, and every repair or
    bail shows as a section merged on the caller's thread."""
    repaired = inline = 0
    for data, expect in case():
        want = _reference(data)
        got, stats, (repairs, full_redo) = _parse(data, 4)
        _assert_same(got, want)
        assert full_redo == expect.get("full_redo", full_redo)
        assert repairs <= expect.get("max_repairs", repairs)
        assert want.get("status", 0) == expect.get("status",
                                                   want.get("status", 0))
        if repairs or got.get("status", 0):
            assert stats["merged_inline"] > 0, stats
        repaired += repairs
        inline += stats["merged_inline"]
    if case in (_entry_sweep, _entry_bursts):
        assert repaired >= 1  # the sweep hit a section's entry frame
    if case in (_mid_bail, _denser_tail):
        assert inline >= 1


@pytest.mark.parametrize("when", ["begin", "step", "bail"])
def test_mt_merge_close(when):
    """close() stops and joins the merger and the workers straight after
    begin, after one step and after a bail, and a second close() does
    nothing."""
    stream = _bail_stream() if when == "bail" else _mt_stream()
    inc = host.parse_mlp_stream_begin(stream, threads=8)
    if when == "step":
        inc.step(64)
    elif when == "bail":
        assert inc.step(0) is False and inc.status == 1
    closer = threading.Thread(target=inc.close)
    closer.start()
    closer.join(5)
    assert not closer.is_alive(), "close() hung"
    inc.close()
    assert inc.merge_stats()["parse_sections"] == 0

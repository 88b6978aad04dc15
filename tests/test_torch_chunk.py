"""One chunk's arenas through both chunk programs, and the port's arena
builder against dvda_tpu's.

The arenas (int32/int16/int8) and their static spec are what mp_pack and
dvda_tpu's _NativeArenaBuilder produce; they are captured from dvda_tpu by
replacing its jitted chunk program with a recorder, then run through
dvda_tpu's _uniform_arena_pipeline and through the port's
uniform_arena_pipeline (plain versions on the CPU).  Bit-exact.
"""

import numpy as np
import pytest
import torch

from dvda_tpu import host
from dvda_tpu.codecs.mlp import native_engine as ne
from dvda_tpu_torch.codecs.mlp import native_engine as port_ne
from dvda_tpu_torch.ops.chunk_filter import chunk_filter
from dvda_tpu_torch.ops.chunk_lanes import chunk_lanes_reference, chunk_layout
from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl_reference
from dvda_tpu_torch.testutil import (MlpSynthConfig, synth_mlp_stream,
                                     unfused_chunk_inputs)

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")

torch.set_num_threads(1)

UNIFORM = dict(fir_across_restart=False, params_update_prob=0.0)
STREAMS = {
    "stereo": dict(channel_assignment=1, n_frames=24, seed=2, **UNIFORM),
    "5.1": dict(channel_assignment=17, substream_count=2, n_frames=24,
                seed=3, **UNIFORM),
    "16bit": dict(channel_assignment=1, bits_per_sample=16,
                  sample_rate=48000, n_frames=24, seed=4, **UNIFORM),
    # parameters re-sent inside chains: the per-block parameter arenas
    "param_updates": dict(channel_assignment=17, substream_count=2,
                          n_frames=24, restart_every=4, major_sync_every=4,
                          seed=12, fir_across_restart=False,
                          params_update_prob=0.4),
}


def _chunk_inputs(stream, skip_split=None):
    """Full parse (or, with ``skip_split``, a skip-values parse with that
    sub-lane split) + the uniform-chunk dispatch inputs (parse, subs_info,
    period, L0), derived as the production path does."""
    if skip_split is None:
        parse = host.parse_mlp_stream(stream)
    else:
        inc = host.parse_mlp_stream_begin(stream, skip_values=True,
                                          sub_every=skip_split)
        inc.step(0)
        parse = inc.view()
        parse.inc = inc  # the view does not own the parse buffers
    assert parse is not None and parse.status == 0
    F = ne._frame_cut(parse.frame_end, np.zeros(0, np.int64), len(stream))
    L0 = int(parse.frame_len[0])
    subs_info = []
    for s in range(parse.substream_count):
        sub = parse.sub[s]
        nb_keep = int(sub["fr_nblocks"][:F].sum())
        S0 = int(sub["len"][0])
        restarts = np.nonzero(sub["restart"][:nb_keep])[0]
        coupled = sub["fir_any"][restarts] != 0
        starts = [0] + [int(r) for i, r in enumerate(restarts)
                        if r != 0 and not coupled[i]]
        NB0 = int(np.diff(starts + [nb_keep])[0])
        subs_info.append((sub, 0, S0, NB0))
    return parse, subs_info, subs_info[0][2] * subs_info[0][3], L0


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_chunk_program_and_arenas_match(name, monkeypatch):
    cfg = MlpSynthConfig(**STREAMS[name])
    stream = synth_mlp_stream(cfg)
    parse, subs_info, period, L0 = _chunk_inputs(stream)
    out_ch = cfg.channels
    pack_bits = ne._pack_bits(cfg.bits_per_sample)
    nc = subs_info[0][0]["NB"] // subs_info[0][3] - 1  # a partial chunk
    CHUNK = nc + 2
    mat_mm = ne._max_matrix_slots(parse.mat_active)
    jax_program = ne._uniform_arena_pipeline
    monkeypatch.setattr(ne, "_uniform_arena_pipeline",
                        lambda a4, a2, a1, spec, words=None:
                        (a4, a2, a1, spec))
    a4, a2, a1, spec = ne._dispatch_uniform_chunk(
        parse, [si + (0,) for si in subs_info], 0, nc, CHUNK, period, L0,
        out_ch, pack_bits=pack_bits, mat_mm=mat_mm)
    ref = np.asarray(jax_program(a4, a2, a1, spec))
    per_block = any(entry[0] == "s0_rc_fir" for entry in spec)
    assert per_block == (name == "param_updates")

    got = port_ne.uniform_arena_pipeline(
        *port_ne.arenas_to_device(a4, a2, a1, spec, "cpu"), spec).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)

    (p4, p2, p1), pspec = port_ne._build_chunk_arenas(
        parse, subs_info, 0, nc, CHUNK, period, L0, out_ch, pack_bits, 0, 0,
        mat_mm)
    assert pspec == spec
    for mine, theirs in ((p4, a4), (p2, a2), (p1, a1)):
        assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)

    # a full chunk skips the zero fill: mp_pack must write every element
    # (the uninitialised buffers are poisoned to show any hole)
    f4, f2, f1, fspec = ne._dispatch_uniform_chunk(
        parse, [si + (0,) for si in subs_info], 0, nc, nc, period, L0,
        out_ch, pack_bits=pack_bits, mat_mm=mat_mm)
    with monkeypatch.context() as m:
        m.setattr(port_ne.np, "empty",
                  lambda n, dt: np.full(n, 0x55, dt))
        (q4, q2, q1), qspec = port_ne._build_chunk_arenas(
            parse, subs_info, 0, nc, nc, period, L0, out_ch, pack_bits, 0, 0,
            mat_mm)
    assert qspec == fspec
    for mine, theirs in ((q4, f4), (q2, f2), (q1, f1)):
        assert np.array_equal(mine, theirs)
    parse.close()


@pytest.mark.parametrize("name,split", [("stereo", 0), ("5.1", 8),
                                        ("param_updates", 7)])
def test_device_huffman_chunk_matches(name, split, monkeypatch):
    """A device-Huffman chunk (skip-values parse, decode tables, the track's
    shared words) captured from dvda_tpu: both chunk programs agree, and the
    port builds the same arenas, spec and words."""
    cfg = MlpSynthConfig(**STREAMS[name])
    stream = synth_mlp_stream(cfg)
    parse, subs_info, period, L0 = _chunk_inputs(stream, split)
    pack_bits = ne._pack_bits(cfg.bits_per_sample)
    nc = subs_info[0][0]["NB"] // subs_info[0][3] - 1  # a partial chunk
    mat_mm = ne._max_matrix_slots(parse.mat_active)
    jax_program = ne._uniform_arena_pipeline
    monkeypatch.setattr(ne, "_uniform_arena_pipeline",
                        lambda a4, a2, a1, spec, words=None:
                        (a4, a2, a1, spec, words))
    shared = ne._SharedWords(stream)
    subs = [si + (0,) for si in subs_info]
    words = port_ne._shared_words(stream, torch.device("cpu"))
    assert np.array_equal(words.numpy().view(np.uint32), shared.np)

    for CHUNK in (nc + 2, nc):  # partial, then full (no zero fill)
        a4, a2, a1, spec, jwords = ne._dispatch_uniform_chunk(
            parse, subs, 0, nc, CHUNK, period, L0, cfg.channels,
            pack_bits=pack_bits, mat_mm=mat_mm, words_all=shared)
        assert any(e[0] == "s0_bitpos" for e in spec)
        assert not any(e[0] == "byp" or e[0].endswith("_res") for e in spec)
        if CHUNK > nc:
            ref = np.asarray(jax_program(a4, a2, a1, spec, jwords))
            got = port_ne.uniform_arena_pipeline(
                *port_ne.arenas_to_device(a4, a2, a1, spec, "cpu"), spec,
                words).numpy()
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
        with monkeypatch.context() as m:
            # uninitialised buffers are poisoned to show any hole
            m.setattr(port_ne.np, "empty",
                      lambda n, dt: np.full(n, 0x55, dt))
            (p4, p2, p1), pspec = port_ne._build_chunk_arenas(
                parse, subs, 0, nc, CHUNK, period, L0, cfg.channels,
                pack_bits, 0, 0, mat_mm, huffman=True)
        assert pspec == spec
        for mine, theirs in ((p4, a4), (p2, a2), (p1, a1)):
            assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)
    parse.close()


def test_chunk_program_unfused_substreams():
    """Substreams of different block geometry (same period) run separate
    filter launches and join on the channel axis.  The synthesiser cannot
    make such a stream, so the arenas are built by hand: random values in
    the parser's ranges, per-chain parameter rows."""
    rng = np.random.default_rng(21)
    Bc, L0, fpc, C = 4, 20, 2, 6
    period = L0 * fpc
    F_pad, T_pad = Bc * fpc, Bc * period
    b = port_ne._NativeArenaBuilder(None)
    for s, (n_ch, NB0, S0) in enumerate(((2, 4, 10), (4, 2, 20))):
        b.add_host(f"s{s}_res", rng.integers(
            -2000, 2000, (Bc, NB0, n_ch, S0)).astype(np.int16))
        for name, lo, hi, inner, dt in (
                ("rc_fir", -900, 900, (n_ch, 8), np.int16),
                ("rc_iir", -900, 900, (n_ch, 8), np.int16),
                ("iir_init", -5000, 5000, (n_ch, 8), np.int32),
                ("shift", 8, 13, (n_ch,), np.int8),
                ("quant", 0, 3, (n_ch,), np.int8),
                ("iir_reset", 0, 2, (n_ch,), np.int8)):
            b.add_host(f"s{s}_{name}_c",
                       rng.integers(lo, hi, (Bc,) + inner).astype(dt))
    b.add_host("mat_coeff", rng.integers(-2**14, 2**14, (F_pad, 6, 8))
               .astype(np.int16))
    b.add_host("mat_noise", rng.integers(-2**10, 2**10, (F_pad, 6, 2))
               .astype(np.int16))
    b.add_host("mat_out", rng.integers(0, C, (F_pad, 6)).astype(np.int8))
    b.add_host("mat_active", (rng.random((F_pad, 6)) < 0.8).astype(np.int8))
    b.mark("mat_mm", 6)
    b.add_host("mat_quant", rng.integers(0, 3, (F_pad, 6)).astype(np.int8))
    b.add_host("out_shift", rng.integers(0, 3, (F_pad, 8)).astype(np.int8))
    b.add_host("wave_perm", rng.permutation(C).astype(np.int8))
    b.add_host("frame_seed", rng.integers(0, 2**32, F_pad, dtype=np.uint64)
               .astype(np.uint32))
    b.add_host("frame_nshift", rng.integers(0, 9, F_pad).astype(np.int8))
    b.add_host("byp", rng.integers(0, 64, T_pad).astype(np.int8))
    b.add_host("jumps", np.array([port_ne._jump_columns(k) for k in range(5)],
                                 dtype=np.uint32))
    (a4, a2, a1), spec = b.finish()
    spec = spec + (("__pack24__", 0, 0, (), "flag"),)
    ref = np.asarray(ne._uniform_arena_pipeline(a4, a2, a1, spec))
    got = port_ne.uniform_arena_pipeline(
        *port_ne.arenas_to_device(a4, a2, a1, spec, "cpu"), spec).numpy()
    assert np.array_equal(got, ref)


def test_unfused_chunk_inputs_match_the_hand_built_chunk():
    """``testutil.unfused_chunk_inputs`` at its defaults is the chunk of
    test_chunk_program_unfused_substreams (the card tests and the smoke
    run it), and its program equals dvda_tpu's."""
    (a4, a2, a1), spec = unfused_chunk_inputs()
    assert [(g[0], g[1], g[2]) for g in chunk_layout(spec).groups] == [
        (4, 10, 8), (2, 20, 16)]
    ref = np.asarray(ne._uniform_arena_pipeline(a4, a2, a1, spec))
    got = port_ne.uniform_arena_pipeline(
        *port_ne.arenas_to_device(a4, a2, a1, spec, "cpu"), spec).numpy()
    assert np.array_equal(got, ref)


def test_chunk_program_refuses_unequal_periods():
    """Filter launches whose periods NB0*S0 differ cannot join on the lane
    axis (dvda_tpu's concatenation needs one period): the chunk program
    raises before a filter runs."""
    arenas, spec = unfused_chunk_inputs(geometry=((2, 4, 10), (4, 3, 20)))
    before = chunk_filter.joined
    with pytest.raises(ValueError, match="periods NB0\\*S0 differ"):
        port_ne.uniform_arena_pipeline(
            *port_ne.arenas_to_device(*arenas, spec, "cpu"), spec)
    assert chunk_filter.joined == before


def test_chunk_filter_joins_into_one_series():
    """``chunk_filter`` on the CPU: each launch's filter output at its
    columns of the chunk's one series, in launch order; the join
    counted."""
    arenas, spec = unfused_chunk_inputs()
    a = port_ne.arenas_to_device(*arenas, spec, "cpu")
    before = chunk_filter.joined
    series = chunk_filter(*a, spec)
    assert chunk_filter.joined == before + 1
    assert tuple(series.shape) == (40, 24)
    col = 0
    for args in chunk_lanes_reference(*a, spec).filters:
        out = mlp_filter_blocks_tl_reference(*args)[0]  # [NB0, S0, lanes]
        lanes = out.shape[2]
        assert torch.equal(series[:, col : col + lanes], out.reshape(40, -1))
        col += lanes
    assert col == series.shape[1]


def test_chunk_program_refuses_other_modes():
    """Specs of modes this slice does not port raise instead of decoding."""
    spec = (("__pallas__", 0, 1, (), "flag"),)
    empty = (torch.zeros(0, dtype=torch.int32),
             torch.zeros(0, dtype=torch.int16),
             torch.zeros(0, dtype=torch.int8))
    with pytest.raises(NotImplementedError, match="item 12"):
        port_ne.uniform_arena_pipeline(*empty, spec)
    # device-Huffman arenas without the track's words
    one = (torch.zeros(1, dtype=torch.int32),) + empty[1:]
    with pytest.raises(ValueError, match="stream words"):
        port_ne.uniform_arena_pipeline(*one, (("s0_bitpos", 4, 0, (1, 1, 1),
                                               "int32"),))
    # malformed arenas are refused before any kernel sees a pointer
    with pytest.raises(TypeError, match="arena 4"):
        port_ne.arenas_to_device(np.zeros(4, np.int64), np.zeros(0, np.int16),
                                 np.zeros(0, np.int8), (), "cpu")
    with pytest.raises(ValueError, match="overruns"):
        port_ne.arenas_to_device(np.zeros(4, np.int32), np.zeros(0, np.int16),
                                 np.zeros(0, np.int8),
                                 (("x", 4, 2, (3,), "int32"),), "cpu")

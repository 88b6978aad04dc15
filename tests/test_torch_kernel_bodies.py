"""The CUDA kernels' lane bodies, compiled for the CPU, against the plain
PyTorch versions.

csrc/huffman_decode.cuh, csrc/mlp_filter.cuh, csrc/output_stage.cuh,
csrc/pcm_unpack.cuh, csrc/c2_decrypt.cuh, csrc/general_gather.cuh,
csrc/frame_remix.cuh and csrc/chunk_lanes.cuh hold the per-lane code that nvcc compiles into the
card's kernels; csrc/cpu_harness.cc runs the same bodies for g++, tile by
tile and, within a tile, phase by phase for each thread as the kernel's
barriers order them.  This is the only check of the kernels'
arithmetic that runs without a card.  Tolerance: 0 (integer decode).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from dvda_tpu.codecs.pcm import chunk_size, pcm_gather_indices
from dvda_tpu.container.aob import AOBReader
from dvda_tpu.cppm.c2 import SBOX, SBOX_F
from dvda_tpu.cppm.decrypt import CppmDecryptor
from dvda_tpu_torch.ops.c2_decrypt import decrypt_sectors_reference
from dvda_tpu_torch.ops.chunk_filter import chunk_filter_reference
from dvda_tpu_torch.ops.chunk_lanes import (_views, chunk_lanes_reference,
                                            chunk_layout)
from dvda_tpu_torch.ops.general_gather import (general_pipeline_reference,
                                               lane_pack_reference,
                                               series_remix_reference)
from dvda_tpu_torch.ops.huffman_decode import decode_residuals_reference
from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl_reference
from dvda_tpu_torch.ops.pcm_unpack import decode_chunks_reference
from dvda_tpu_torch.ops.rematrix import (apply_output_stage_reference,
                                         output_stage_reference,
                                         rematrix_frames_reference)
from dvda_tpu_torch.testutil import (C2_EDGES, CHUNK_LANES_EDGES,
                                     FILTER_EDGES,
                                     FRAME_REMIX_EDGES, HUFFMAN_EDGES,
                                     LANE_PACK_EDGES, NARROW_EDGES,
                                     NARROW_RANGES, OUTPUT_STAGE_EDGES,
                                     PCM_EDGES, SERIES_REMIX_EDGES,
                                     c2_edge_batch, chunk_lanes_inputs,
                                     chunk_filter_staging_inputs,
                                     MlpSynthConfig, MlpTrackSpec,
                                     PcmTrackSpec, build_disc,
                                     cppm_sector_mix, filter_inputs,
                                     frame_remix_inputs,
                                     frame_remix_offsets,
                                     general_inputs, huffman_inputs,
                                     huffman_edge_inputs,
                                     huffman_worst_case,
                                     narrow_stage_inputs,
                                     output_stage_inputs, synth_mlp_stream)

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dvda_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    so = str(tmp_path_factory.mktemp("harness") / "libharness.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-o", so, os.path.join(CSRC, "cpu_harness.cc")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cpu_mlp_filter.restype = None
    lib.cpu_mlp_filter.argtypes = [p] * 13 + [i, i, i]
    lib.cpu_output_stage.restype = None
    lib.cpu_output_stage.argtypes = [p] * 12 + [i] * 7
    lib.cpu_output_stage_narrow.restype = None
    lib.cpu_output_stage_narrow.argtypes = [p] * 12 + [i] * 7
    lib.cpu_huffman_decode.restype = None
    i64 = ctypes.c_int64
    lib.cpu_huffman_decode.argtypes = ([p, i64, i64] + [p] * 11 + [i] * 7
                                       + [i64, i64, i, i, p])
    lib.cpu_chunk_lanes.restype = i
    lib.cpu_chunk_lanes.argtypes = [p, i64] + [p] * 4
    lib.cpu_chunk_filter.restype = i
    lib.cpu_chunk_filter.argtypes = ([p, i64] + [p] * 3 + [i64] * 3
                                     + [p] * 2 + [i] * 3)
    lib.cpu_pcm_unpack.restype = None
    lib.cpu_pcm_unpack.argtypes = [p, i64, i, i, i, i, p, p]
    lib.cpu_c2_decrypt.restype = None
    lib.cpu_c2_decrypt.argtypes = [p, i64, ctypes.c_uint64, i, p, p]
    lib.cpu_lane_pack.restype = None
    lib.cpu_lane_pack.argtypes = [p] * 20 + [i] * 4
    lib.cpu_frame_remix.restype = i
    lib.cpu_frame_remix.argtypes = [p] * 10 + [i] * 5 + [ctypes.c_uint, p]
    lib.cpu_series_remix.restype = None
    lib.cpu_series_remix.argtypes = ([p, p, i, p, p, i] + [p] * 11
                                     + [i64, i, i, p])
    lib.cpu_lfsr_at.restype = None
    lib.cpu_lfsr_at.argtypes = [p, i, i64, i, p]
    return lib


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


@pytest.mark.parametrize("seed,shape,extreme,states", [
    (0, (128, 4, 16), False, False),
    (1, (128, 4, 16), False, True),
    (9, (128, 2, 8), True, False),
])
def test_filter_body_matches_plain(harness, seed, shape, extreme, states):
    B, NB, S = shape
    args = filter_inputs(seed, B, NB, S, extreme, states)
    out = np.empty((NB, S, B), np.int32)
    fs = np.empty((B, 8), np.int32)
    is_ = np.empty((B, 8), np.int32)
    irst = args[5].astype(np.uint8)
    c_args = list(args[:5]) + [irst] + list(args[6:])
    harness.cpu_mlp_filter(*[_ptr(a) for a in c_args], _ptr(out), _ptr(fs),
                           _ptr(is_), B, NB, S)
    ref = mlp_filter_blocks_tl_reference(*map(torch.from_numpy, args))
    assert np.array_equal(out, ref[0].numpy())
    assert np.array_equal(fs, ref[1].numpy())
    assert np.array_equal(is_, ref[2].numpy())


@pytest.mark.parametrize("shape", FILTER_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_filter_body_edge_shapes(harness, shape):
    """K1's body through the kernel's 32-lane blocks and 32-row tiles at
    the edge shapes: ragged lane counts, NB = 1, S = 1, S off and across
    the tiles, short blocks, resets, the extreme values."""
    B, NB, S, extreme, states = shape
    args = filter_inputs(B + S, B, NB, S, extreme, states)
    out = np.empty((NB, S, B), np.int32)
    fs = np.empty((B, 8), np.int32)
    is_ = np.empty((B, 8), np.int32)
    c_args = list(args[:5]) + [args[5].astype(np.uint8)] + list(args[6:])
    harness.cpu_mlp_filter(*[_ptr(a) for a in c_args], _ptr(out), _ptr(fs),
                           _ptr(is_), B, NB, S)
    ref = mlp_filter_blocks_tl_reference(*map(torch.from_numpy, args))
    for got, want in zip((out, fs, is_), ref, strict=True):
        assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("nbytes", [0, 2, 3])
@pytest.mark.parametrize("extreme", [False, True])
def test_output_stage_body_matches_plain(harness, nbytes, extreme):
    Bc, fpc, L0, C_tot, C_out = 8, 4, 8, 6, 6
    inp = output_stage_inputs(3 + nbytes, Bc, fpc, L0, C_tot, C_out,
                              extreme=extreme)
    T = Bc * fpc * L0
    out = np.zeros((T, C_out * (nbytes or 4)), np.uint8)
    harness.cpu_output_stage(*[_ptr(a) for a in inp.values()], _ptr(out),
                             Bc, fpc, L0, C_tot, C_out, 6, nbytes)
    ref = output_stage_reference(
        *map(torch.from_numpy, inp.values()), chains=Bc, n_mats=6,
        nbytes=nbytes).numpy()
    if nbytes == 0:
        out = out.view(np.int32)
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("shape", OUTPUT_STAGE_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_output_stage_body_edge_shapes(harness, shape):
    """K234's body at the edge shapes: ragged chain counts, L0 of 40, 80,
    160 and 200, C_out < C_tot, 0-6 slots, every output form."""
    Bc, fpc, L0, C_tot, C_out, n_mats, nbytes, extreme = shape
    inp = output_stage_inputs(L0 + n_mats, Bc, fpc, L0, C_tot, C_out,
                              extreme=extreme)
    out = np.zeros((Bc * fpc * L0, C_out * (nbytes or 4)), np.uint8)
    harness.cpu_output_stage(*[_ptr(a) for a in inp.values()], _ptr(out),
                             Bc, fpc, L0, C_tot, C_out, n_mats, nbytes)
    ref = output_stage_reference(
        *map(torch.from_numpy, inp.values()), chains=Bc, n_mats=n_mats,
        nbytes=nbytes).numpy()
    assert np.array_equal(out.view(np.int32) if nbytes == 0 else out, ref)


def _narrow_check(harness, inp, Bc, fpc, L0, C_tot, C_out, n_mats, tier):
    """K234n's body (the narrow pack, the fits test, the flag rows)
    against the plain version; returns the flag."""
    row = C_out * 2 if tier == 16 else C_out // 2 * 3
    out = np.full((Bc * fpc * L0 + 8, row), 0x55, np.uint8)
    harness.cpu_output_stage_narrow(*[_ptr(a) for a in inp.values()],
                                    _ptr(out), Bc, fpc, L0, C_tot, C_out,
                                    n_mats, tier)
    ref = output_stage_reference(
        *map(torch.from_numpy, inp.values()), chains=Bc, n_mats=n_mats,
        nbytes=3, tier=tier).numpy()
    assert np.array_equal(out, ref)
    return int(out[-1, -1])


@pytest.mark.parametrize("case", NARROW_EDGES,
                         ids=lambda c: "-".join(map(str, c[0])) + f"-t{c[1]}")
def test_narrow_body_edge_shapes(harness, case):
    """K234n's body at K234's edge shapes, tier 12 (even C_out) and 16."""
    (Bc, fpc, L0, C_tot, C_out, n_mats, _, extreme), tier = case
    inp = output_stage_inputs(L0 + n_mats, Bc, fpc, L0, C_tot, C_out,
                              extreme=extreme)
    _narrow_check(harness, inp, Bc, fpc, L0, C_tot, C_out, n_mats, tier)


@pytest.mark.parametrize("lo,hi,flag12,flag16", NARROW_RANGES)
@pytest.mark.parametrize("tier", [12, 16])
def test_narrow_body_fits_edges(harness, lo, hi, flag12, flag16, tier):
    """The fits test with samples exactly at the tiers' ends (-2,048 and
    2,047 fit 12 bits, -2,049 and 2,048 do not; likewise at 32,768): the
    flag of each tier."""
    inp = narrow_stage_inputs(7, 5, 2, 40, 6, 6, lo, hi)
    flag = _narrow_check(harness, inp, 5, 2, 40, 6, 6, 6, tier)
    assert flag == (flag12 if tier == 12 else flag16)


def _at_offset(a: np.ndarray, k: int) -> np.ndarray:
    """A contiguous copy of ``a`` whose data starts ``k`` elements past a
    64-byte boundary."""
    step = 64 // a.itemsize
    buf = np.empty(a.size + 2 * step + k, a.dtype)
    start = (-(buf.ctypes.data // a.itemsize)) % step + k
    view = buf[start : start + a.size].reshape(a.shape)
    view[...] = a
    return view


def _frame_remix_check(harness, args, n_mats, offsets=(0, 0, 0)):
    """K9's tile body, tile by tile and each tile's phases thread by thread,
    against the plain versions, with channels, noise and output at
    ``offsets`` elements past a 64-byte boundary: (vector body taken, most
    pieces a tile staged)."""
    channels, noise, *tables, out_shift, wave_perm = args
    F, L, C = channels.shape
    C_out = wave_perm.shape[0]
    out = _at_offset(np.zeros((F, L, C_out), np.int32), offsets[2])
    perm = sum(int(v) << (4 * k) for k, v in enumerate(wave_perm))
    c_args = ([_at_offset(channels, offsets[0]), _at_offset(noise, offsets[1])]
              + tables[:3] + [tables[3].astype(np.uint8)] + tables[4:]
              + [out_shift])
    vec = ctypes.c_int(-1)
    pieces = harness.cpu_frame_remix(*[_ptr(a) for a in c_args], _ptr(out),
                                     F, L, C, C_out, n_mats, perm,
                                     ctypes.byref(vec))
    t = [torch.from_numpy(a) for a in args]
    ref = apply_output_stage_reference(
        rematrix_frames_reference(*t[:8], n_mats), t[8], t[9])
    assert np.array_equal(out, ref.numpy())
    return bool(vec.value), pieces


@pytest.mark.parametrize("n_mats", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 7, 8])
def test_frame_remix_body_matches_plain(harness, C, n_mats):
    """K9's body at every channel count and slot bound, with int32-extreme
    channels and bypass addends and output channels past C."""
    args = frame_remix_inputs(10 * C + n_mats, 3, 24, C, min(C + 1, 8),
                              extreme=True)
    _frame_remix_check(harness, args, n_mats)


@pytest.mark.parametrize("extreme", [False, True])
def test_frame_remix_body_shift_edges(harness, extreme):
    """Quant steps and output shifts at and past 32 (and negative): XLA's
    rule, 0, on both sides (the body goes through dvda_mask_quant and
    dvda_shl, where a plain C++ shift would be undefined)."""
    args = frame_remix_inputs(5, 8, 40, 8, 6, extreme=extreme, edges=True)
    _frame_remix_check(harness, args, 6)


@pytest.mark.parametrize("case", FRAME_REMIX_EDGES, ids=lambda c: c[0])
def test_frame_remix_body_edge_cases(harness, case):
    """K9's tile body at ``testutil.FRAME_REMIX_EDGES``: rows off the tile,
    frames across tiles, tiles of more frames than one piece stages, every
    C, C_out and n_mats, and the element path where a base is not aligned
    to the vectors."""
    name, F, L, C, C_out, n_mats, extreme, edges, _ = case
    args = frame_remix_inputs(FRAME_REMIX_EDGES.index(case), F, L, C, C_out,
                              extreme=extreme, edges=edges)
    offsets = frame_remix_offsets(case)
    vec, pieces = _frame_remix_check(harness, args, n_mats, offsets)
    # the body the launcher picks: vectors only from aligned bases
    assert vec == (offsets[2] * 4 % 16 == 0 and offsets[1] * 4 % 8 == 0
                   and (C != 8 or offsets[0] * 4 % 16 == 0))
    tiles = [(b * 256 % L, min(256, F * L - b * 256))
             for b in range(-(-F * L // 256))]
    assert pieces == max(-(-((t0 + n - 1) // L + 1) // 16)
                         for t0, n in tiles)
    assert pieces > 1 or name != "L1"


def _huffman_check(harness, case, NB0, slots, window_words=-1, trim=0,
                   lane0=0, extra=0):
    """K5's body, block by block as the kernel runs it (``window_words``
    < 0: the kernel's staging budget; 0: every block reads the words in
    place; ``trim``: windows staged that many words short, so that blocks
    decode again from the words), against the plain version; returns
    (residuals, blocks staged, blocks decoded again).  With ``lane0`` /
    ``extra`` (NB0 > 0) the residuals go to lanes [lane0, lane0 + C*Bc) of
    rows that many lanes wider, the others must stay as they were."""
    L, C = case["codebook"].shape
    nsub = case["bitpos"].shape[1]
    S0 = case["S0"]
    width = C * L // NB0 if NB0 > 0 else 0
    stride = lane0 + width + extra
    res = np.full((NB0 * S0 * stride if NB0 > 0 else C * L * S0,), -7,
                  np.int32)
    field = np.zeros((L, S0), np.int32)
    bits = np.zeros(L * S0, np.int8)
    tabs = [np.ascontiguousarray(case[n]) for n in (
        "bitpos", "codebook", "lsb_bits", "offset", "quant", "nbyp", "bypk",
        "bypv")]
    counts = np.zeros(2, np.int32)
    harness.cpu_huffman_decode(
        _ptr(case["words"]), case["words"].size, case.get("word_base", 0),
        *[_ptr(t) for t in tabs[:6]],
        *([_ptr(tabs[6]), _ptr(tabs[7])] if slots else [None, None]),
        _ptr(res), None if slots else _ptr(field), _ptr(bits) if slots
        else None, L, nsub, C, S0, case["k"], int(case["J"] == C + 1), NB0,
        stride, lane0, window_words, trim, _ptr(counts))
    ref = decode_residuals_reference(
        torch.from_numpy(case["words"].view(np.int32)),
        *map(torch.from_numpy, tabs[:6]), S0, case["J"], case["k"], NB0=NB0,
        word_base=case.get("word_base"),
        bypk=torch.from_numpy(tabs[6]) if slots else None,
        bypv=torch.from_numpy(tabs[7]) if slots else None)
    if NB0 > 0:
        rows = res.reshape(NB0, S0, stride)
        res = np.ascontiguousarray(rows[:, :, lane0 : lane0 + width])
        rest = np.concatenate([rows[:, :, :lane0], rows[:, :, lane0 + width:]],
                              2)
        assert (rest == -7).all()
    assert np.array_equal(res.reshape(ref[0].shape), ref[0].numpy())
    assert np.array_equal(bits if slots else field, ref[1].numpy())
    return res, int(counts[0]), int(counts[1])


@pytest.mark.parametrize("seed,L,nsub,C,S0,k,NB0,burst,slots", [
    (0, 64, 1, 4, 40, 40, 0, True, False),
    (1, 64, 3, 2, 40, 16, 8, True, True),
    (2, 32, 2, 6, 16, 8, 4, False, False),
    (3, 32, 1, 1, 9, 9, 2, True, True),
])
def test_huffman_body_matches_plain(harness, seed, L, nsub, C, S0, k, NB0,
                                    burst, slots):
    case = huffman_inputs(seed, L, nsub, C, S0, k, burst)
    res, _, _ = _huffman_check(harness, case, NB0, slots)
    assert (res < 0).any() and (res > 0).any()


@pytest.mark.parametrize("source", ["window", "device"])
@pytest.mark.parametrize("edge", [e for e in HUFFMAN_EDGES if e[7] > 0],
                         ids=lambda e: e[0])
def test_huffman_body_at_lane_offset(harness, edge, source):
    """K5 writing its residuals into lanes of a wider, fused filter input
    (the chunk program's ``out``/``lane0``), through the staged window and
    from the words in place: the lanes as alone, the other lanes kept."""
    case = huffman_edge_inputs(edge)
    _huffman_check(harness, case, case["NB0"], case["slots"],
                   -1 if source == "window" else 0, lane0=5, extra=3)


def test_huffman_body_worst_case(harness):
    """The widest symbols from all 32 start alignments."""
    for align in range(32):
        case = huffman_worst_case(align)
        mask = case["byp_mask"][:, None] >> np.arange(6) & 1
        case.update(bypk=(np.cumsum(mask, 1) - mask).astype(np.int8),
                    bypv=mask.astype(np.int8))
        for slots in (False, True):
            _huffman_check(harness, case, 0, slots)


def _huffman_blocks(case):
    """Thread blocks of K5's launch for ``case``: whole chains (NB0
    blocks of nsub sub-lanes, NB0 == 0: a lane) filling 128 sub-lanes."""
    L, nsub, NB0 = case["bitpos"].shape[0], case["bitpos"].shape[1], \
        case["NB0"]
    per = max(NB0, 1) * nsub
    chains = max(1, 128 // per)
    return -(-(L // max(NB0, 1)) // chains)


@pytest.mark.parametrize("source", ["window", "device", "short"])
@pytest.mark.parametrize("edge", HUFFMAN_EDGES, ids=lambda e: e[0])
def test_huffman_body_edge_cases(harness, edge, source):
    """K5 at the edge cases through the staged window where a block's
    fits, with every block reading the words in place, and with windows
    cut to their first word (every staged block reads past it and decodes
    again from the words)."""
    case = huffman_edge_inputs(edge)
    res, staged, again = _huffman_check(
        harness, case, case["NB0"], case["slots"],
        {"window": -1, "device": 0, "short": -1}[source],
        1 << 30 if source == "short" else 0)
    assert (res < 0).any() and (res > 0).any()
    blocks = _huffman_blocks(case)
    if source == "device":
        assert staged == again == 0
    elif case["name"] in ("mixed", "corrupt"):
        assert 0 < staged < blocks
    else:
        assert staged == blocks
    assert again == (staged if source == "short" else 0)


@pytest.mark.parametrize("align", range(32))
def test_huffman_body_worst_case_chain(harness, align):
    """The widest symbols as one chain of 3 blocks (NB0 = 3, the main
    path's time-leading layout), staged and in place."""
    case = huffman_worst_case(align)
    mask = case["byp_mask"][:, None] >> np.arange(6) & 1
    case.update(bypk=(np.cumsum(mask, 1) - mask).astype(np.int8),
                bypv=mask.astype(np.int8))
    for window in (-1, 0):
        _, staged, again = _huffman_check(harness, case, 3, True, window)
        assert (staged, again) == ((1, 0) if window else (0, 0))


def _pcm_body(harness, chunks, bits, channels, nbytes):
    n = chunks.shape[0]
    table = np.ascontiguousarray(pcm_gather_indices(bits, channels),
                                 np.int32)
    out = np.full(2 * n * channels * (nbytes or 4) + 1, 0xAB, np.uint8)
    harness.cpu_pcm_unpack(_ptr(chunks), n, chunks.shape[1], channels, bits,
                           nbytes, _ptr(table), _ptr(out))
    assert out[-1] == 0xAB  # nothing written past the output
    out = out[:-1]
    return out.view(np.int32) if nbytes == 0 else out


@pytest.mark.parametrize("nbytes", [0, 2, 3])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_pcm_unpack_body_matches_plain(harness, bits, channels, nbytes):
    """All (bps, ch) configs, incl. the -1 table entries (16-bit third
    bytes, 20-bit unwritten positions), in both output forms."""
    rng = np.random.default_rng(bits + channels + nbytes)
    chunks = rng.integers(0, 256, (33, chunk_size(bits, channels)),
                          dtype=np.uint8)
    got = _pcm_body(harness, chunks, bits, channels, nbytes)
    ref = decode_chunks_reference(torch.from_numpy(chunks), bits, channels,
                                  nbytes).numpy()
    assert np.array_equal(got.reshape(ref.shape), ref)


def test_pcm_unpack_body_empty(harness):
    got = _pcm_body(harness, np.zeros((0, 36), np.uint8), 24, 6, 0)
    assert got.size == 0


@pytest.mark.parametrize("n", PCM_EDGES)
def test_pcm_unpack_body_edges(harness, n):
    """The tile body at chunk counts around its 256-chunk tile, at every
    (bps, ch) config in every output form: ragged last tiles, outputs
    that end inside a 16-byte vector."""
    rng = np.random.default_rng(n)
    for bits in (16, 20, 24):
        for channels in range(1, 7):
            chunks = rng.integers(0, 256, (n, chunk_size(bits, channels)),
                                  dtype=np.uint8)
            for nbytes in (0, 2, 3):
                got = _pcm_body(harness, chunks, bits, channels, nbytes)
                ref = decode_chunks_reference(torch.from_numpy(chunks), bits,
                                              channels, nbytes).numpy()
                assert np.array_equal(got.reshape(ref.shape), ref), (
                    bits, channels, nbytes)


@pytest.fixture(scope="module")
def cppm_sectors(tmp_path_factory):
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=16, seed=6,
                         fir_across_restart=False)
    layout = build_disc(str(tmp_path_factory.mktemp("cppm") / "AUDIO_TS"), [[
        PcmTrackSpec(pcm_frames=960, seed=8, sample_rate=96000,
                     bits_per_sample=24, channel_assignment=17),
        MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                     pcm_frames=mlp.total_pcm_frames, sample_rate=96000,
                     channel_assignment=17)]])
    return AOBReader(layout.path, 1).read_sectors(0, 12).copy()


_KEYS = (0x00DEADBEEF001122, 0x0F0E0D0C0B0A0908)


@pytest.fixture(scope="module")
def cppm_mix(cppm_sectors):
    return cppm_sector_mix(cppm_sectors, *_KEYS), CppmDecryptor(*_KEYS).k_au


def _c2_body(harness, enc, k_au, preserve_cci):
    """The K7 body as the card runs it, on a copy of ``enc``."""
    got = enc.copy()
    sbox = np.ascontiguousarray(SBOX, np.uint32)
    sbox_f = np.ascontiguousarray(SBOX_F, np.uint32)
    harness.cpu_c2_decrypt(_ptr(got), got.shape[0], k_au, int(preserve_cci),
                           _ptr(sbox), _ptr(sbox_f))
    return got


@pytest.mark.parametrize("wrong_key", [False, True])
@pytest.mark.parametrize("preserve_cci", [False, True])
def test_c2_decrypt_body_matches_plain(harness, cppm_mix, preserve_cci,
                                       wrong_key):
    """Non-pack, clear and scrambled sectors, CCI walks that reach the
    sector's end (one at its last byte), and a wrong key."""
    (plain, enc), k_au = cppm_mix
    k_au ^= 1 << 40 if wrong_key else 0
    got = _c2_body(harness, enc, k_au, preserve_cci)
    ref = decrypt_sectors_reference(torch.from_numpy(enc), k_au,
                                    preserve_cci).numpy()
    assert np.array_equal(got, ref)
    if not wrong_key:
        assert np.array_equal(got, plain) == preserve_cci


@pytest.mark.parametrize("wrong_key", [False, True])
@pytest.mark.parametrize("preserve_cci", [False, True])
@pytest.mark.parametrize("n,seed", C2_EDGES)
def test_c2_decrypt_body_edges(harness, cppm_sectors, n, seed, preserve_cci,
                               wrong_key):
    """Batches around the kernel's 32-sector blocks, each block mixing
    scrambled, clear and non-pack sectors, through the staged tile."""
    plain, enc = c2_edge_batch(cppm_sectors, n, *_KEYS, seed)
    k_au = CppmDecryptor(*_KEYS).k_au ^ (1 << 40 if wrong_key else 0)
    ref = decrypt_sectors_reference(torch.from_numpy(enc), k_au,
                                    preserve_cci).numpy()
    got = _c2_body(harness, enc, k_au, preserve_cci)
    assert np.array_equal(got, ref)
    if preserve_cci and not wrong_key:
        assert np.array_equal(ref, plain)


_PACK_KEYS = ("res", "res_off", "lens", "bidx", "bmask", "rc_fir", "rc_iir",
              "iir_init", "shift", "quant", "iir_reset")


def _lane_pack_body(harness, u):
    Bc, NB = u["bidx"].shape
    n_ch = u["shift"].shape[1]
    B, S = Bc * n_ch, u["S"]
    outs = [np.full((NB, S, B), 7, np.int32)] + [
        np.full(shape, 7, dt) for shape, dt in (
            ((B, NB, 8), np.int32), ((B, NB, 8), np.int32),
            ((B, NB), np.int32), ((B, NB), np.int32), ((B, NB), np.uint8),
            ((B, NB, 8), np.int32), ((B, NB), np.int32), ((B, 8), np.int32))]
    ins = [np.ascontiguousarray(u[k]).view(np.uint8) if u[k].dtype == bool
           else np.ascontiguousarray(u[k]) for k in _PACK_KEYS]
    res_tl, fir, iir, shift, quant, reset, init, blen, state0 = outs
    harness.cpu_lane_pack(*[_ptr(a) for a in ins], _ptr(res_tl), _ptr(fir),
                          _ptr(iir), _ptr(init), _ptr(shift), _ptr(quant),
                          _ptr(reset), _ptr(blen), _ptr(state0), B, NB, S,
                          n_ch)
    return (res_tl, fir, iir, shift, quant, reset.view(bool), init, blen,
            state0)


def _torch_tables(subs, frames):
    return ([{k: v if k == "S" else torch.from_numpy(v) for k, v in u.items()}
             for u in subs], tuple(map(torch.from_numpy, frames)))


@pytest.mark.parametrize("extreme", [False, True])
def test_lane_pack_body_matches_plain(harness, extreme):
    """K6a: every output of the lane pack, incl. masked chain positions."""
    subs, frames = general_inputs(4, extreme=extreme)
    for u, t in zip(subs, _torch_tables(subs, frames)[0]):
        got = _lane_pack_body(harness, u)
        ref = lane_pack_reference(t)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert np.array_equal(g, r.numpy())
        assert not got[7].all()  # some positions lie past their chain


@pytest.mark.parametrize("shape", LANE_PACK_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_lane_pack_body_edge_shapes(harness, shape):
    """K6a at the edge shapes: each substream width 1-6, chain counts off
    the 128-lane tile, blocks shorter than S, masked chain positions."""
    n_ch, S, n_blocks, extreme = shape
    subs, frames = general_inputs(0, n_blocks=n_blocks, S=S, n_ch=(n_ch,),
                                  extreme=extreme)
    Bc = subs[0]["bidx"].shape[0]
    assert Bc % (128 // n_ch) and subs[0]["S"] == S
    got = _lane_pack_body(harness, subs[0])
    for g, r in zip(got, lane_pack_reference(
            _torch_tables(subs, frames)[0][0]), strict=True):
        assert np.array_equal(g, r.numpy())
    assert not got[7].all() and (got[0] == 0).any()


@pytest.mark.parametrize("extreme,n_ch", [(False, (2, 4)), (True, (2, 4)),
                                          (False, (6,))])
def test_general_path_body_matches_plain(harness, extreme, n_ch):
    """K6a, K1 and K6b bodies in a chain against
    ``general_pipeline_reference``: one or two substreams, an empty frame,
    and the int32 extremes through the filter and the matrix chain."""
    subs, frames = general_inputs(5, n_ch=n_ch, extreme=extreme)
    outs = []
    for u in subs:
        res_tl, fir, iir, shift, quant, reset, init, blen, st = \
            _lane_pack_body(harness, u)
        NB, S, B = res_tl.shape
        out = np.empty((NB, S, B), np.int32)
        fs, is_ = np.empty((B, 8), np.int32), np.empty((B, 8), np.int32)
        harness.cpu_mlp_filter(*[_ptr(a) for a in (
            res_tl, fir, iir, shift, quant, reset.view(np.uint8), init, blen,
            st, st, out, fs, is_)], B, NB, S)
        outs.append((out, np.ascontiguousarray(u["series_idx"]),
                     u["shift"].shape[1]))
    (o0, i0, c0), (o1, i1, c1) = (outs + [(outs[0][0], outs[0][1], 0)])[:2]
    T = frames[1].shape[0]
    F = frames[0].shape[0] - 1
    fr = [np.ascontiguousarray(f).view(np.uint8) if f.dtype == bool
          else np.ascontiguousarray(f) for f in frames]
    got = _series_remix_body(harness, outs, frames)[0]
    ref = general_pipeline_reference(*_torch_tables(subs, frames)).numpy()
    assert np.array_equal(got, ref)
    assert (ref < 0).any() and (ref > 0).any()


def _series_remix_body(harness, outs, frames):
    """K6b's body through the kernel's 512-row tiles: (rows, pieces run)."""
    (o0, i0, c0), (o1, i1, c1) = (outs + [(outs[0][0], outs[0][1], 0)])[:2]
    T = frames[1].shape[0]
    F = frames[0].shape[0] - 1
    fr = [np.ascontiguousarray(f).view(np.uint8) if f.dtype == bool
          else np.ascontiguousarray(f) for f in frames]
    got = np.full((T, len(fr[-1])), 7, np.int32)
    pieces = np.zeros(1, np.int32)
    harness.cpu_series_remix(_ptr(o0), _ptr(i0), c0, _ptr(o1), _ptr(i1), c1,
                             *[_ptr(f) for f in fr], _ptr(got), T, F,
                             len(fr[-1]), _ptr(pieces))
    return got, int(pieces[0])


@pytest.mark.parametrize("edge", SERIES_REMIX_EDGES, ids=lambda e: e[0])
def test_series_remix_body_edge_cases(harness, edge):
    """K6b's tiles at its edges (T off the 512-row tile, frames longer
    than a tile, runs of empty frames at the start, at and across a tile
    edge and at the end, more frames in a tile than a 16-frame piece, one
    frame, one and two substreams, the int32 extremes) on full-range K1
    outputs, against the plain version."""
    name, n_ch, n_blocks, S, extreme, starts = edge
    subs, frames = general_inputs(0, n_blocks=n_blocks, S=S, n_ch=n_ch,
                                  extreme=extreme, frame_starts=starts)
    rng = np.random.default_rng(len(name))
    outs = [(rng.integers(-2**31, 2**31, (u["bidx"].shape[1], u["S"],
                                          u["bidx"].shape[0] * nc),
                          dtype=np.int64).astype(np.int32),
             np.ascontiguousarray(u["series_idx"]), nc)
            for u, nc in zip(subs, n_ch)]
    T = frames[1].shape[0]
    got, pieces = _series_remix_body(harness, outs, frames)
    ref = series_remix_reference(
        [(torch.from_numpy(o), torch.from_numpy(i), nc) for o, i, nc in outs],
        *map(torch.from_numpy, frames)).numpy()
    assert T % 512 and np.array_equal(got, ref)
    tiles = -(-T // 512)
    assert (pieces > tiles) == name.startswith("dense")


@pytest.mark.parametrize("L0", [40, 80, 160, 200, 300])
def test_lfsr_jump_matches_steps(harness, L0):
    """K234's LFSR jump (dvda_lfsr_at: M^(16q) from the constant table,
    then single steps; past 256 steps more than one jump) against
    dvda_lfsr_step stepped serially, and against the step in numpy, at
    every offset 0..L0-1 from 64 seeds."""
    rng = np.random.default_rng(L0)
    seeds = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    seeds[:2] = (0, 0xFFFFFFFF)
    state = seeds.astype(np.uint64)
    got, steps = np.empty_like(seeds), np.empty_like(seeds)
    for i in range(L0):
        harness.cpu_lfsr_at(_ptr(seeds), seeds.size, i, 0, _ptr(got))
        harness.cpu_lfsr_at(_ptr(seeds), seeds.size, i, 1, _ptr(steps))
        assert np.array_equal(got, steps), i
        assert np.array_equal(got, state.astype(np.uint32)), i
        sh = (state >> 7) & 0xFFFF
        state = ((state << 16) ^ sh ^ (sh << 5)) & 0xFFFFFFFF


def _chunk_lanes_body(harness, arenas, spec):
    """K10's body over its grid (ops/chunk_lanes.py's descriptor and
    output buffer, poisoned), as the views the wrapper returns; None
    where the entry refuses the descriptor (a standard chunk's)."""
    lay = chunk_layout(spec)
    out32 = np.full(max(lay.n32, 1), 0x55555555, np.int32)
    a4, a2, a1 = (np.ascontiguousarray(a) for a in arenas)

    def run(n_words=lay.desc.size):
        return harness.cpu_chunk_lanes(_ptr(lay.desc), n_words, _ptr(a4),
                                       _ptr(a2), _ptr(a1), _ptr(out32))

    assert run(lay.desc.size - 1) == -1
    rc = run()
    if not lay.huffman:
        assert rc == -1
        return lay, None
    assert rc == 0
    return lay, _views(lay, torch.from_numpy(out32))


@pytest.mark.parametrize("case", CHUNK_LANES_EDGES, ids=lambda c: c[0])
def test_chunk_lanes_body_edge_cases(harness, case):
    """K10's body against the plain front end at every edge case: in
    device Huffman K5's lane inputs (per-chain and per-block rows, fused
    and unfused substreams) with every element written and the residual
    buffers left to K5 (still poisoned); a standard chunk's descriptor
    refused (its filter, K1a, reads the arenas)."""
    arenas, spec = chunk_lanes_inputs(case)
    lay, got = _chunk_lanes_body(harness, arenas, spec)
    if not case[4]:
        assert got is None
        return
    ref = chunk_lanes_reference(*map(torch.from_numpy, arenas), spec)
    assert got.filters is None and got.places == ref.places
    for mine, theirs in zip(got.huffman, ref.huffman, strict=True):
        for m, t in zip(mine, theirs, strict=True):
            assert m.shape == t.shape and torch.equal(m, t)
    for r, f in zip(got.residuals, ref.filters, strict=True):
        assert r.shape == f[0].shape and (r == 0x55555555).all()


def _chunk_filter_body(harness, arenas, spec, residuals=None):
    """K1a's body per filter launch (ops/chunk_lanes.py's group
    descriptors; outputs poisoned), and the entry's refusals."""
    lay = chunk_layout(spec)
    a4, a2, a1 = arenas
    outs = []
    for g, (desc, (NB0, S0, lanes, _)) in enumerate(zip(lay.group_descs,
                                                        lay.groups)):
        out = np.full((NB0, S0, lanes), 0x55555555, np.int32)
        res = None if residuals is None else _ptr(residuals[g])

        def run(n_words=desc.size, B=lanes, S=S0, res=res):
            return harness.cpu_chunk_filter(
                _ptr(desc), n_words, _ptr(a4), _ptr(a2), _ptr(a1), a4.size,
                a2.size, a1.size, res, _ptr(out), B, NB0, S)

        assert run(n_words=desc.size - 1) == -1
        assert run(B=lanes + 1) == -1 and run(S=S0 + 1) == -1
        if residuals is not None:  # K5's residuals: not in the arenas
            assert run(res=None) == -1
        assert run() == 0
        outs.append(out)
    return lay, outs


@pytest.mark.parametrize("case", CHUNK_LANES_EDGES, ids=lambda c: c[0])
def test_chunk_filter_body_edge_cases(harness, case):
    """K1a's body (each thread's lane resolved in the group's descriptor,
    its residual rows read from the arenas at their width tile by tile,
    K1's sample loop through the arena policy) against its plain version
    (K10's, then K1's): per-chain and per-block rows, fused and unfused
    substreams, 32-lane blocks across channel and substream boundaries,
    a partial chunk, int8/int16/int32 residual arenas, one lane; in
    device Huffman on given residual buffers (K5's, here random)."""
    arenas, spec = chunk_lanes_inputs(case, filter_domain=True)
    lay = chunk_layout(spec)
    residuals = None
    if lay.huffman:
        rng = np.random.default_rng(CHUNK_LANES_EDGES.index(case))
        residuals = [rng.integers(-2**31, 2**31, (NB0, S0, lanes),
                                  dtype=np.int64).astype(np.int32)
                     for NB0, S0, lanes, _ in lay.groups]
    _, got = _chunk_filter_body(harness, arenas, spec, residuals)
    ref = chunk_filter_reference(
        *map(torch.from_numpy, arenas), spec,
        None if residuals is None else list(map(torch.from_numpy,
                                                residuals)))
    for g, (m, t) in enumerate(zip(got, ref, strict=True)):
        assert m.shape == tuple(t.shape) and np.array_equal(m, t.numpy()), g



STAGING = [(c, layout) for c in CHUNK_LANES_EDGES
           for layout in ("res_last", "unaligned", "wide_params")
           if layout == "wide_params" or (not c[4] and c[1][0][2] >= 16)]


@pytest.mark.parametrize("case,layout", STAGING,
                         ids=lambda x: x if isinstance(x, str) else x[0])
def test_chunk_filter_body_staging(harness, case, layout):
    """K1a's residual staging and variants at their edges: the residuals
    at the very end of their arena (the last granule copied in part),
    arenas off 16 bytes (one load a row instead of granules), and
    parameter arrays at other widths than the arena builders' (the
    variant for any widths, also in device Huffman)."""
    arenas, spec = chunk_filter_staging_inputs(case, layout)
    if layout == "unaligned":
        assert all(a.ctypes.data % 16 for a in arenas)
    residuals = None
    if case[4]:
        rng = np.random.default_rng(7)
        residuals = [rng.integers(-2**31, 2**31, g[:3], dtype=np.int64)
                     .astype(np.int32) for g in chunk_layout(spec).groups]
    _, got = _chunk_filter_body(harness, arenas, spec, residuals)
    ref = chunk_filter_reference(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in arenas), spec,
        None if residuals is None else list(map(torch.from_numpy,
                                                residuals)))
    for g, (m, t) in enumerate(zip(got, ref, strict=True)):
        assert np.array_equal(m, t.numpy()), g

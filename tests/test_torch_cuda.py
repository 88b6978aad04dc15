"""Kernels K1, K1a, K234, K234n, K5, K6a, K6b, K7, K8, K9 and K10 on the card
against their plain versions, and the port's decode on the card (both MLP
modes, the general path, the Python engines, the fused decode step, PCM,
an encrypted disc) against its CPU decode.  Marked ``cuda``: they
skip without a CUDA device (run them on a GPU host with
``python -m pytest -m cuda tests/test_torch_cuda.py``).  Bit-exact."""

import os

import numpy as np
import pytest
import torch

from dvda_tpu_torch import DecodeConfig, host, open_disc
from dvda_tpu_torch.api import TrackReader
from dvda_tpu_torch.codecs.params import StreamParameters
from dvda_tpu_torch.codecs.pcm import chunk_size
from dvda_tpu_torch.container.aob import AOBReader
from dvda_tpu_torch.cppm.decrypt import CppmDecryptor
from dvda_tpu_torch.ops.c2_decrypt import (decrypt_sectors_device,
                                           decrypt_sectors_reference)
from dvda_tpu_torch.ops.pcm_unpack import (decode_chunks_device,
                                           decode_chunks_reference)
from dvda_tpu_torch.codecs.mlp import native_engine as ne
from dvda_tpu_torch.codecs.mlp.native_engine import decode_native
from dvda_tpu_torch.ops.chunk_filter import (chunk_filter,
                                             chunk_filter_reference)
from dvda_tpu_torch.ops.chunk_lanes import (chunk_lanes,
                                            chunk_lanes_reference,
                                            chunk_layout)
from dvda_tpu_torch.codecs.mlp.track import decode_segment
from dvda_tpu_torch.ops.huffman_decode import (decode_residuals_device,
                                               decode_residuals_reference)
from dvda_tpu_torch.ops.mlp_filter import (mlp_filter_blocks,
                                           mlp_filter_blocks_tl,
                                           mlp_filter_blocks_tl_reference,
                                           mlp_filter_frames)
from dvda_tpu_torch.ops.general_gather import (lane_pack,
                                               lane_pack_reference,
                                               series_remix,
                                               series_remix_reference)
from dvda_tpu_torch.ops.rematrix import (apply_output_stage_reference,
                                         frame_remix, output_stage,
                                         output_stage_reference,
                                         rematrix_frames_reference)
from dvda_tpu_torch.parallel.mesh import make_mesh
from dvda_tpu_torch.parallel.step import (decode_step, example_batch,
                                          make_sharded_step)
from dvda_tpu_torch.testutil import (BPS_CODE, C2_EDGES,
                                     CHUNK_LANES_EDGES, chunk_lanes_inputs,
                                     chunk_filter_staging_inputs,
                                     FILTER_EDGES,
                                     FRAME_REMIX_EDGES, frame_remix_edge_args,
                                     HUFFMAN_EDGES, PCM_EDGES, c2_edge_batch,
                                     LANE_PACK_EDGES, NARROW_EDGES,
                                     NARROW_RANGES,
                                     OUTPUT_STAGE_EDGES, RATE_CODE,
                                     MlpSynthConfig, MlpTrackSpec,
                                     PcmTrackSpec, SERIES_REMIX_EDGES,
                                     build_disc,
                                     cppm_sector_mix, encrypt_sectors_batch,
                                     filter_inputs, frame_channels,
                                     frame_remix_inputs,
                                     general_inputs, huffman_inputs,
                                     huffman_edge_inputs, huffman_worst_case,
                                     narrow_stage_inputs, output_stage_inputs,
                                     synth_mlp_stream, unfused_chunk_inputs)
from dvda_tpu_torch.utils.profiling import device_idle_share

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed,shape,extreme", [
    (0, (128, 4, 16), False), (9, (128, 2, 8), True), (2, (1536, 16, 40),
                                                       False)])
def test_filter_kernel_matches_plain(dev, seed, shape, extreme):
    args = [torch.from_numpy(np.asarray(a)).to(dev)
            for a in filter_inputs(seed, *shape, extreme, states=True)]
    before = mlp_filter_blocks_tl.launches
    got = mlp_filter_blocks_tl(*args)
    assert mlp_filter_blocks_tl.launches == before + 1
    ref = mlp_filter_blocks_tl_reference(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("shape", FILTER_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_filter_kernel_edge_shapes(dev, shape):
    """K1's 32-lane blocks and 32-row staged tiles: ragged lane counts (the
    4-byte copy where B % 4 != 0), NB = 1, S = 1, S off and across the
    tiles, short blocks, resets, the extreme values."""
    B, NB, S, extreme, states = shape
    args = [torch.from_numpy(np.asarray(a)).to(dev)
            for a in filter_inputs(B + S, B, NB, S, extreme, states)]
    before = mlp_filter_blocks_tl.launches
    got = mlp_filter_blocks_tl(*args)
    assert mlp_filter_blocks_tl.launches == before + 1
    for g, r in zip(got, mlp_filter_blocks_tl_reference(*args), strict=True):
        assert torch.equal(g, r)


@pytest.mark.parametrize("layout", ["lane_leading", "frame_major"])
@pytest.mark.parametrize("shape", FILTER_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_filter_kernel_layouts(dev, shape, layout):
    """K1 on lane-leading residuals, staged in place, writing lane-leading
    output (``mlp_filter_blocks``; null initial states where the case has
    none) or the frame-major channels (``mlp_filter_frames``: zero states,
    no final states), one launch each, against the plain version behind
    permutes at the edge shapes: lane counts off 4 and 32 (C the lanes'
    largest divisor of at most 8), NB*S off 4 (the 4-byte copy) and 32,
    S < 8, short blocks, resets, the extremes."""
    B, NB, S, extreme, states = shape
    args = [torch.from_numpy(np.asarray(a)).to(dev)
            for a in filter_inputs(B + S, B, NB, S, extreme, states)]
    res = args[0].permute(2, 0, 1).contiguous()
    before = mlp_filter_blocks_tl.launches
    if layout == "lane_leading":
        ref = mlp_filter_blocks_tl_reference(*args)
        got = mlp_filter_blocks(res, *args[1:8],
                                *(args[8:] if states else (None, None)))
        want = (ref[0].permute(2, 0, 1), ref[1], ref[2])
    else:  # the step's filter: zero states
        C = frame_channels(B)
        got = (mlp_filter_frames(*(a.reshape((B // C, C) + a.shape[1:])
                                   for a in [res] + args[1:8])),)
        want = (mlp_filter_blocks_tl_reference(*args[:8], None, None)[0]
                .reshape(NB * S, B // C, C).transpose(0, 1),)
    assert mlp_filter_blocks_tl.launches == before + 1
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nbytes", [0, 2, 3])
@pytest.mark.parametrize("extreme", [False, True])
def test_output_stage_kernel_matches_plain(dev, nbytes, extreme):
    inp = output_stage_inputs(nbytes, 16, 4, 40, 6, 6, extreme=extreme)
    args = [torch.from_numpy(v).to(dev) for v in inp.values()]
    before = output_stage.launches
    got = output_stage(*args, chains=16, n_mats=6, nbytes=nbytes)
    assert output_stage.launches == before + 1
    ref = output_stage_reference(*args, chains=16, n_mats=6, nbytes=nbytes)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", OUTPUT_STAGE_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_output_stage_kernel_edge_shapes(dev, shape):
    """K234's tiles and strips: ragged chain counts, L0 of 40-200, C_out <
    C_tot, 0-6 slots, every output form (the staged word stores)."""
    Bc, fpc, L0, C_tot, C_out, n_mats, nbytes, extreme = shape
    inp = output_stage_inputs(L0 + n_mats, Bc, fpc, L0, C_tot, C_out,
                              extreme=extreme)
    args = [torch.from_numpy(v).to(dev) for v in inp.values()]
    kw = dict(chains=Bc, n_mats=n_mats, nbytes=nbytes)
    before = output_stage.launches
    got = output_stage(*args, **kw)
    assert output_stage.launches == before + 1
    assert torch.equal(got, output_stage_reference(*args, **kw))


def _narrow_kernel_check(dev, inp, Bc, n_mats, tier):
    """K234n on the card against its plain version, flag rows included,
    with one launch counted apart; returns the flag."""
    args = [torch.from_numpy(v).to(dev) for v in inp.values()]
    kw = dict(chains=Bc, n_mats=n_mats, nbytes=3, tier=tier)
    before = (output_stage.launches, output_stage.narrow_launches)
    got = output_stage(*args, **kw)
    assert (output_stage.launches,
            output_stage.narrow_launches) == (before[0], before[1] + 1)
    assert torch.equal(got, output_stage_reference(*args, **kw))
    return int(got[-1, -1])


@pytest.mark.parametrize("case", NARROW_EDGES,
                         ids=lambda c: "-".join(map(str, c[0])) + f"-t{c[1]}")
def test_narrow_kernel_edge_shapes(dev, case):
    """K234n at K234's edge shapes, tier 12 (even C_out) and 16."""
    (Bc, fpc, L0, C_tot, C_out, n_mats, _, extreme), tier = case
    inp = output_stage_inputs(L0 + n_mats, Bc, fpc, L0, C_tot, C_out,
                              extreme=extreme)
    _narrow_kernel_check(dev, inp, Bc, n_mats, tier)


@pytest.mark.parametrize("lo,hi,flag12,flag16", NARROW_RANGES)
@pytest.mark.parametrize("tier", [12, 16])
def test_narrow_kernel_fits_edges(dev, lo, hi, flag12, flag16, tier):
    """The fits test across the grid's blocks, samples at the tiers' ends:
    the flag of each tier."""
    inp = narrow_stage_inputs(7, 70, 4, 80, 6, 6, lo, hi)
    flag = _narrow_kernel_check(dev, inp, 70, 6, tier)
    assert flag == (flag12 if tier == 12 else flag16)


@pytest.mark.parametrize("tier", [12, 16])
def test_narrow_kernel_resets_its_scratch(dev, tier):
    """Two K234n launches in a row on one stream: a chunk that misses both
    tiers, then one that fits both.  The second flag is the second chunk's
    own (3 at tier 12, 1 at tier 16): the first launch's last block left
    the stream's misfit word and ticket at zero."""
    loud = narrow_stage_inputs(7, 70, 4, 80, 6, 6, -32769, 32768)
    quiet = narrow_stage_inputs(8, 70, 4, 80, 6, 6, -2048, 2047)
    assert _narrow_kernel_check(dev, loud, 70, 6, tier) == 0
    assert _narrow_kernel_check(dev, quiet, 70, 6, tier) == (
        3 if tier == 12 else 1)


@pytest.mark.parametrize("huffman", [False, True])
@pytest.mark.parametrize("shifts,tier", [((0, 1), 12), ((5, 6), 16),
                                         ((7, 8), 0)])
def test_narrow_decode_on_card(dev, huffman, shifts, tier):
    """Quiet, mid and loud 24-bit streams on the card, narrow readback on
    and off: equal to each other and to the CPU decode; the tier settles
    at 12, 16 and 0."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=24, seed=11, out_shift_range=shifts)
    stream = synth_mlp_stream(cfg)
    params = StreamParameters(BPS_CODE[24], 0xF, RATE_CODE[cfg.sample_rate],
                              0xF, 17)
    bnd = np.zeros(0, np.int64)
    ref = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cpu", narrow_d2h=False))
    for narrow in (True, False):
        info = {}
        got = decode_native(stream, bnd, len(stream), params, True,
                            DecodeConfig(device="cuda", narrow_d2h=narrow,
                                         device_huffman=huffman), info=info)
        assert np.array_equal(got, ref)
        assert info["tier"] == (tier if narrow else 0)


def test_kernel_rejects_bad_arguments(dev):
    args = [torch.from_numpy(np.asarray(a)).to(dev)
            for a in filter_inputs(0, 64, 2, 8)]
    args[1] = args[1].to(torch.int16)
    with pytest.raises(TypeError, match="rc_fir"):
        mlp_filter_blocks_tl(*args)


@pytest.mark.parametrize("chunk_chains", [2, 256])
def test_decode_on_card_matches_cpu(dev, chunk_chains):
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=48, seed=2,
                         fir_across_restart=False, params_update_prob=0.3)
    stream = synth_mlp_stream(cfg)
    params = StreamParameters(BPS_CODE[24], 0xF, RATE_CODE[96000], 0xF, 17)
    bnd = np.zeros(0, np.int64)
    got = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cuda",
                                     chunk_chains=chunk_chains))
    ref = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cpu", chunk_chains=chunk_chains))
    assert np.array_equal(got, ref)


def _general_tables(dev, **kw):
    subs, frames = general_inputs(**kw)
    return ([{k: v if k == "S" else torch.from_numpy(np.asarray(v)).to(dev)
              for k, v in u.items()} for u in subs],
            tuple(torch.from_numpy(np.asarray(f)).to(dev) for f in frames))


@pytest.mark.parametrize("extreme", [False, True])
def test_lane_pack_kernel_matches_plain(dev, extreme):
    subs, _ = _general_tables(dev, seed=2, n_blocks=300, S=40,
                              extreme=extreme)
    for u in subs:
        before = lane_pack.launches
        got = lane_pack(u)
        assert lane_pack.launches == before + 1
        for g, r in zip(got, lane_pack_reference(u), strict=True):
            assert torch.equal(g, r)


@pytest.mark.parametrize("shape", LANE_PACK_EDGES,
                         ids=lambda s: "-".join(map(str, s)))
def test_lane_pack_kernel_edge_shapes(dev, shape):
    """K6a's tiles: each substream width, a ragged last tile, blocks
    shorter than S (and S past a 64-row strip), masked positions."""
    n_ch, S, n_blocks, extreme = shape
    subs, _ = _general_tables(dev, seed=0, n_blocks=n_blocks, S=S,
                              n_ch=(n_ch,), extreme=extreme)
    before = lane_pack.launches
    got = lane_pack(subs[0])
    assert lane_pack.launches == before + 1
    for g, r in zip(got, lane_pack_reference(subs[0]), strict=True):
        assert torch.equal(g, r)


@pytest.mark.parametrize("extreme,n_ch",[(False, (2, 4)), (True, (2, 4)),
                                          (False, (6,))])
def test_series_remix_kernel_matches_plain(dev, extreme, n_ch):
    subs, frames = _general_tables(dev, seed=3, n_blocks=300, S=40, F=40,
                                   n_ch=n_ch, extreme=extreme)
    gen = torch.Generator(device="cpu").manual_seed(0)
    outs = []
    for u in subs:
        B = u["bidx"].shape[0] * u["shift"].shape[1]
        shape = (u["bidx"].shape[1], u["S"], B)
        outs.append((torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                   dtype=torch.int32).to(dev),
                     u["series_idx"], u["shift"].shape[1]))
    before = series_remix.launches
    got = series_remix(outs, *frames)
    assert series_remix.launches == before + 1
    assert torch.equal(got, series_remix_reference(outs, *frames))


@pytest.mark.parametrize("edge", SERIES_REMIX_EDGES, ids=lambda e: e[0])
def test_series_remix_kernel_edge_cases(dev, edge):
    """K6b's tiles at its edges (testutil.SERIES_REMIX_EDGES) on full-range
    K1 outputs, against the plain version."""
    name, n_ch, n_blocks, S, extreme, starts = edge
    subs, frames = _general_tables(dev, seed=0, n_blocks=n_blocks, S=S,
                                   n_ch=n_ch, extreme=extreme,
                                   frame_starts=starts)
    gen = torch.Generator(device="cpu").manual_seed(len(name))
    outs = [(torch.randint(-2**31, 2**31 - 1, (u["bidx"].shape[1], u["S"],
                                                u["bidx"].shape[0] * nc),
                           generator=gen, dtype=torch.int32).to(dev),
             u["series_idx"], nc) for u, nc in zip(subs, n_ch)]
    before = series_remix.launches
    got = series_remix(outs, *frames)
    assert series_remix.launches == before + 1
    assert torch.equal(got, series_remix_reference(outs, *frames))


def test_general_decode_on_card(dev):
    """The general path (more than 8 geometry sections) through K6a, K1
    and K6b on the card against the port's CPU decode."""
    stream = b"".join(synth_mlp_stream(MlpSynthConfig(
        channel_assignment=17, substream_count=2, sample_rate=96000,
        blocks_per_frame=2, block_size=40 if i % 2 else 20, n_frames=16,
        restart_every=8, major_sync_every=8, fir_across_restart=False,
        params_update_prob=0.0, seed=40 + i)) for i in range(12))
    params = StreamParameters(BPS_CODE[24], 0xF, RATE_CODE[96000], 0xF, 17)
    bnd = np.zeros(0, np.int64)
    counters = (lane_pack, mlp_filter_blocks_tl, series_remix)
    before = [fn.launches for fn in counters]
    info = {}
    got = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cuda"), info=info)
    assert info["path"] == "general"
    pack, filt, remix = (fn.launches - b for fn, b in zip(counters, before))
    # K1 also ran for the sections the pipelined driver tried first
    assert (pack, remix) == (2, 1) and filt >= 2
    ref = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cpu"))
    assert got.dtype == np.int32 and np.array_equal(got, ref)


def _huffman_args(case, dev):
    t = {n: torch.from_numpy(np.asarray(case[n])).to(dev) for n in (
        "bitpos", "codebook", "lsb_bits", "offset", "quant", "nbyp")}
    words = torch.from_numpy(case["words"].view(np.int32)).to(dev)
    return (words, t["bitpos"], t["codebook"], t["lsb_bits"], t["offset"],
            t["quant"], t["nbyp"], case["S0"], case["J"], case["k"])


@pytest.mark.parametrize("seed,L,nsub,C,S0,k,NB0,slots", [
    (0, 4096, 1, 4, 40, 40, 16, True), (1, 512, 3, 2, 40, 16, 0, False),
    (2, 96, 2, 6, 16, 8, 4, False)])
def test_huffman_kernel_matches_plain(dev, seed, L, nsub, C, S0, k, NB0,
                                      slots):
    case = huffman_inputs(seed, L, nsub, C, S0, k, burst=True)
    args = _huffman_args(case, dev)
    kw = dict(NB0=NB0, word_base=torch.tensor(
        [case["word_base"]], dtype=torch.int32, device=dev))
    if slots:
        kw.update(bypk=torch.from_numpy(case["bypk"]).to(dev),
                  bypv=torch.from_numpy(case["bypv"]).to(dev))
    before = decode_residuals_device.launches
    got = decode_residuals_device(*args, **kw)
    assert decode_residuals_device.launches == before + 1
    ref = decode_residuals_reference(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_huffman_kernel_worst_case(dev):
    for align in range(32):
        args = _huffman_args(huffman_worst_case(align), dev)
        got = decode_residuals_device(*args)
        ref = decode_residuals_reference(*args)
        for g, r in zip(got, ref):
            assert torch.equal(g, r), align


@pytest.mark.parametrize("edge", HUFFMAN_EDGES, ids=lambda e: e[0])
def test_huffman_kernel_edge_cases(dev, edge):
    """K5's blocks of whole chains: windows that fit and ones that read
    device memory (spread or corrupt tables), a ragged last block, words
    outside the stream, nsub > 1, NB0 == 0, C = 8 and 9."""
    case = huffman_edge_inputs(edge)
    args = _huffman_args(case, dev)
    kw = dict(NB0=case["NB0"], word_base=torch.tensor(
        [case["word_base"]], dtype=torch.int32, device=dev))
    if case["slots"]:
        kw.update(bypk=torch.from_numpy(case["bypk"]).to(dev),
                  bypv=torch.from_numpy(case["bypv"]).to(dev))
    before = decode_residuals_device.launches
    got = decode_residuals_device(*args, **kw)
    assert decode_residuals_device.launches == before + 1
    for g, r in zip(got, decode_residuals_reference(*args, **kw),
                    strict=True):
        assert torch.equal(g, r)


def test_huffman_kernel_worst_case_chain(dev):
    """The 39-bit symbols at every alignment as one chain of 3 blocks."""
    for align in range(32):
        args = _huffman_args(huffman_worst_case(align), dev)
        got = decode_residuals_device(*args, NB0=3)
        ref = decode_residuals_reference(*args, NB0=3)
        for g, r in zip(got, ref, strict=True):
            assert torch.equal(g, r), align


@pytest.mark.parametrize("lane0,extra", [(0, 0), (5, 3)])
def test_huffman_kernel_at_lane_offset(dev, lane0, extra):
    """K5 writing into lanes [lane0, lane0 + C*Bc) of a wider, fused
    filter input (``out``): those lanes as alone, the others kept."""
    case = huffman_edge_inputs(HUFFMAN_EDGES[0])
    args = _huffman_args(case, dev)
    kw = dict(NB0=case["NB0"], word_base=torch.tensor(
        [case["word_base"]], dtype=torch.int32, device=dev),
        bypk=torch.from_numpy(case["bypk"]).to(dev),
        bypv=torch.from_numpy(case["bypv"]).to(dev))
    want, want_byp = decode_residuals_reference(*args, **kw)
    width = want.shape[2]
    out = torch.full((*want.shape[:2], lane0 + width + extra), -7,
                     dtype=torch.int32, device=dev)
    before = decode_residuals_device.launches
    got, byp = decode_residuals_device(*args, **kw, out=out, lane0=lane0)
    assert decode_residuals_device.launches == before + 1
    assert got is out and torch.equal(byp, want_byp)
    assert torch.equal(out[:, :, lane0 : lane0 + width], want)
    assert (out[:, :, :lane0] == -7).all()
    assert (out[:, :, lane0 + width:] == -7).all()


@pytest.mark.parametrize("case", CHUNK_LANES_EDGES, ids=lambda c: c[0])
def test_chunk_lanes_kernel_edge_cases(dev, case):
    """K10 against the plain front end on the card at its edge cases, in
    one launch: a device-Huffman chunk's K5 inputs (fused and unfused
    substreams, per-chain and per-block rows) and its residual buffers'
    shapes; a standard chunk refused before any launch."""
    arenas, spec = chunk_lanes_inputs(case)
    a = [torch.from_numpy(x).to(dev) for x in arenas]
    before = chunk_lanes.launches
    if not case[4]:
        with pytest.raises(ValueError, match="no K5 inputs"):
            chunk_lanes(*a, spec)
        assert chunk_lanes.launches == before
        return
    got = chunk_lanes(*a, spec)
    assert chunk_lanes.launches == before + 1 and got.filters is None
    ref = chunk_lanes_reference(*a, spec)
    assert [r.shape for r in got.residuals] == [f[0].shape
                                                for f in ref.filters]
    for mine, theirs in zip(got.huffman, ref.huffman, strict=True):
        for m, t in zip(mine, theirs, strict=True):
            assert torch.equal(m, t)


@pytest.mark.parametrize("case", CHUNK_LANES_EDGES, ids=lambda c: c[0])
def test_chunk_filter_kernel_edge_cases(dev, case):
    """K1a against its plain version on the card at K10's edge cases, one
    launch per filter launch; in device Huffman on random residual
    buffers standing in for K5's."""
    arenas, spec = chunk_lanes_inputs(case, filter_domain=True)
    a = [torch.from_numpy(x).to(dev) for x in arenas]
    lay = chunk_layout(spec)
    res = None
    if lay.huffman:
        gen = torch.Generator().manual_seed(len(case[0]))
        res = [torch.randint(-2**31, 2**31 - 1, (NB0, S0, lanes),
                             generator=gen, dtype=torch.int32).to(dev)
               for NB0, S0, lanes, _ in lay.groups]
    before = chunk_filter.launches
    got = chunk_filter(*a, spec, res)
    assert chunk_filter.launches == before + len(lay.groups)
    assert torch.equal(got, chunk_filter_reference(*a, spec, res))


@pytest.mark.parametrize("case,layout", [
    (c, layout) for c in CHUNK_LANES_EDGES
    for layout in ("res_last", "unaligned", "wide_params")
    if layout == "wide_params" or (not c[4] and c[1][0][2] >= 16)],
    ids=lambda x: x if isinstance(x, str) else x[0])
def test_chunk_filter_kernel_staging(dev, case, layout):
    """K1a's residual staging and variants on the card at their edges:
    the residuals at the end of their arena (the last 16-byte cp.async
    cut to the arena), arenas off 16 bytes (one load a row), parameter
    arrays at other widths (the variant for any widths)."""
    arenas, spec = chunk_filter_staging_inputs(case, layout)
    a = []
    for x in arenas:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if layout == "unaligned":  # the same elements, one past 16 bytes
            t = torch.cat([t[:1], t])[1:]
            assert t.data_ptr() % 16
        a.append(t)
    res = None
    if case[4]:
        gen = torch.Generator().manual_seed(7)
        res = [torch.randint(-2**31, 2**31 - 1, g[:3], generator=gen,
                             dtype=torch.int32).to(dev)
               for g in chunk_layout(spec).groups]
    got = chunk_filter(*a, spec, res)
    assert torch.equal(got, chunk_filter_reference(*a, spec, res))


def test_chunk_filter_rejects_bad_inputs(dev):
    arenas, spec = chunk_lanes_inputs(CHUNK_LANES_EDGES[-1])
    a = [torch.from_numpy(x).to(dev) for x in arenas]
    res = chunk_lanes(*a, spec).residuals
    with pytest.raises(ValueError, match="arena 4"):
        chunk_filter(a[0][:3], a[1], a[2], spec, res)
    with pytest.raises(ValueError, match="residuals 1"):
        chunk_filter(*a, spec, [res[0], res[1][:, :1]])
    with pytest.raises(ValueError, match="needs 2 residual"):
        chunk_filter(*a, spec)


def test_chunk_lanes_rejects_bad_arenas(dev):
    arenas, spec = chunk_lanes_inputs(CHUNK_LANES_EDGES[-1])
    a = [torch.from_numpy(x).to(dev) for x in arenas]
    with pytest.raises(TypeError, match="arena 2"):
        chunk_lanes(a[0], a[2], a[2], spec)
    with pytest.raises(ValueError, match="arena 4"):
        chunk_lanes(a[0][:3], a[1], a[2], spec)


@pytest.mark.parametrize("huffman", [False, True])
def test_chunk_program_launches_port_kernels(dev, huffman):
    """A uniform decode on the card launches K1a once a chunk (the
    substreams fused) and, in device Huffman, K10 (its K5 inputs) and K5
    per substream before it; never K1; bytes equal to the CPU's."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=48, seed=2,
                         fir_across_restart=False, params_update_prob=0.0)
    stream = synth_mlp_stream(cfg)
    params = StreamParameters(BPS_CODE[24], 0xF, RATE_CODE[96000], 0xF, 17)
    bnd = np.zeros(0, np.int64)
    counters = (chunk_lanes, chunk_filter, mlp_filter_blocks_tl,
                decode_residuals_device)
    before = [fn.launches for fn in counters]
    info = {}
    got = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cuda", device_huffman=huffman,
                                     chunk_chains=2), info=info)
    k10, k1a, k1, k5 = (fn.launches - b for fn, b in zip(counters, before))
    assert info["path"] in ("pipelined", "uniform")
    assert k1a > 0 and k1 == 0
    assert k10 == (k1a if huffman else 0)
    assert k5 == (2 * k1a if huffman else 0)
    ref = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cpu", device_huffman=huffman,
                                     chunk_chains=2))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("split", [0, 8])
def test_device_huffman_decode_on_card(dev, split):
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=48, seed=5,
                         fir_across_restart=False, params_update_prob=0.3)
    stream = synth_mlp_stream(cfg)
    params = StreamParameters(BPS_CODE[24], 0xF, RATE_CODE[96000], 0xF, 17)
    bnd = np.zeros(0, np.int64)
    before = decode_residuals_device.launches
    got = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cuda", device_huffman=True,
                                     huffman_split=split, chunk_chains=2))
    assert decode_residuals_device.launches > before
    std = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cuda"))
    cpu = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cpu", device_huffman=True,
                                     huffman_split=split, chunk_chains=2))
    assert np.array_equal(got, std) and np.array_equal(got, cpu)


@pytest.mark.parametrize("nbytes", [0, 2, 3])
@pytest.mark.parametrize("bits", [16, 20, 24])
def test_pcm_unpack_kernel_matches_plain(dev, bits, nbytes):
    rng = np.random.default_rng(bits + nbytes)
    for ch in range(1, 7):
        for n in (0, 1, 64, 5000):
            chunks = torch.from_numpy(rng.integers(
                0, 256, (n, chunk_size(bits, ch)), dtype=np.uint8)).to(dev)
            before = decode_chunks_device.launches
            got = decode_chunks_device(chunks, bits, ch, nbytes)
            assert decode_chunks_device.launches == before + (n > 0)
            ref = decode_chunks_reference(chunks, bits, ch, nbytes)
            assert torch.equal(got, ref), (ch, n)


@pytest.mark.parametrize("n", PCM_EDGES)
def test_pcm_unpack_kernel_edges(dev, n):
    """Chunk counts around the kernel's 256-chunk tile at every config in
    every output form."""
    rng = np.random.default_rng(n)
    for bits in (16, 20, 24):
        for ch in range(1, 7):
            chunks = torch.from_numpy(rng.integers(
                0, 256, (n, chunk_size(bits, ch)), dtype=np.uint8)).to(dev)
            for nbytes in (0, 2, 3):
                got = decode_chunks_device(chunks, bits, ch, nbytes)
                ref = decode_chunks_reference(chunks, bits, ch, nbytes)
                assert torch.equal(got, ref), (bits, ch, nbytes)


def test_pcm_unpack_rejects_misaligned(dev):
    buf = torch.zeros(64 * 36 + 4, dtype=torch.uint8, device=dev)
    view = buf[4:].view(64, 36)
    before = decode_chunks_device.launches
    with pytest.raises(ValueError, match="16-byte alignment"):
        decode_chunks_device(view, 24, 6, 3)
    assert decode_chunks_device.launches == before


def _mix_disc(path):
    mlp = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=48, seed=6,
                         fir_across_restart=False, params_update_prob=0.0)
    return build_disc(path, [[
        PcmTrackSpec(pcm_frames=9600, seed=8, sample_rate=96000,
                     bits_per_sample=24, channel_assignment=17),
        MlpTrackSpec(mlp_stream=synth_mlp_stream(mlp),
                     pcm_frames=mlp.total_pcm_frames, sample_rate=96000,
                     channel_assignment=17),
        PcmTrackSpec(pcm_frames=4800, seed=1)]])


KEYS = (0x00DEADBEEF001122, 0x0F0E0D0C0B0A0908)


@pytest.mark.parametrize("preserve_cci", [False, True])
def test_c2_decrypt_kernel_matches_plain(dev, tmp_path, preserve_cci):
    layout = _mix_disc(str(tmp_path / "AUDIO_TS"))
    sectors = AOBReader(layout.path, 1).read_sectors(0, 300)
    plain, enc = cppm_sector_mix(sectors, *KEYS)
    k_au = CppmDecryptor(*KEYS).k_au
    t = torch.from_numpy(enc).to(dev)
    before = decrypt_sectors_device.launches
    assert decrypt_sectors_device(t, k_au, preserve_cci) is t
    assert decrypt_sectors_device.launches == before + 1
    ref = decrypt_sectors_reference(torch.from_numpy(enc).to(dev), k_au,
                                    preserve_cci)
    assert torch.equal(t, ref)
    want = enc.copy()
    assert host.c2_decrypt_sectors(want, *KEYS, preserve_cci) > 0
    assert np.array_equal(t.cpu().numpy(), want)
    empty = torch.zeros((0, 2048), dtype=torch.uint8, device=dev)
    decrypt_sectors_device(empty, k_au)
    assert decrypt_sectors_device.launches == before + 1


@pytest.fixture(scope="module")
def mix_sectors(tmp_path_factory):
    layout = _mix_disc(str(tmp_path_factory.mktemp("mix") / "AUDIO_TS"))
    return AOBReader(layout.path, 1).read_sectors(0, 300).copy()


@pytest.mark.parametrize("wrong_key", [False, True])
@pytest.mark.parametrize("preserve_cci", [False, True])
@pytest.mark.parametrize("n,seed", C2_EDGES)
def test_c2_decrypt_kernel_edges(dev, mix_sectors, n, seed, preserve_cci,
                                 wrong_key):
    """Batches around the kernel's 32-sector blocks, each block mixing
    scrambled, clear and non-pack sectors: the kernel against its plain
    version, and with the right key against the port's host C2."""
    plain, enc = c2_edge_batch(mix_sectors, n, *KEYS, seed)
    k_au = CppmDecryptor(*KEYS).k_au ^ (1 << 40 if wrong_key else 0)
    t = torch.from_numpy(enc).to(dev)
    decrypt_sectors_device(t, k_au, preserve_cci)
    ref = decrypt_sectors_reference(torch.from_numpy(enc).to(dev), k_au,
                                    preserve_cci)
    assert torch.equal(t, ref)
    if not wrong_key:
        want = enc.copy()
        host.c2_decrypt_sectors(want, *KEYS, preserve_cci)
        assert np.array_equal(t.cpu().numpy(), want)


def test_c2_decrypt_rejects_misaligned(dev):
    buf = torch.zeros(3 * 2048 + 4, dtype=torch.uint8, device=dev)
    view = buf[4:].view(3, 2048)
    before = decrypt_sectors_device.launches
    with pytest.raises(ValueError, match="16-byte alignment"):
        decrypt_sectors_device(view, CppmDecryptor(*KEYS).k_au)
    assert decrypt_sectors_device.launches == before
    assert not buf.any()


def test_encrypted_disc_on_card_matches_cpu(dev, tmp_path):
    """An encrypted PCM + MLP + PCM disc decoded on the card (K7, K8, K1,
    K234) against the port's CPU decode of the plaintext disc."""
    layout = _mix_disc(str(tmp_path / "AUDIO_TS"))
    cpu = DecodeConfig(device="cpu")
    title = open_disc(layout.path, config=cpu).open_titleset(1).open_title(1)
    want = [title.open_track(n).open_reader().read_all_packed()
            for n in (1, 2, 3)]
    samples = title.open_track(1).open_reader().read_all()
    aob = os.path.join(layout.path, "ATS_01_1.AOB")
    raw = np.fromfile(aob, dtype=np.uint8).reshape(-1, 2048)
    encrypt_sectors_batch(raw, *KEYS).tofile(aob)
    cuda = DecodeConfig(device="cuda")
    dec = CppmDecryptor(*KEYS, config=cuda)
    before = (decrypt_sectors_device.launches, decode_chunks_device.launches)
    for n in (1, 2, 3):
        r = TrackReader(AOBReader(layout.path, 1, decrypt=dec.decrypt_sectors),
                        title.open_track(n), config=cuda)
        assert r.read_all_packed() == want[n - 1], n
    assert decrypt_sectors_device.launches > before[0]
    assert decode_chunks_device.launches >= before[1] + 2
    r = TrackReader(AOBReader(layout.path, 1, decrypt=dec.decrypt_sectors),
                    title.open_track(1), config=cuda)
    assert np.array_equal(r.read_all(), samples)


@pytest.mark.parametrize("C,n_mats,extreme,edges", [
    (8, 6, False, False), (6, 3, True, False), (3, 1, True, False),
    (8, 6, True, True)])
def test_frame_remix_kernel_matches_plain(dev, C, n_mats, extreme, edges):
    args = [torch.from_numpy(a).to(dev) for a in frame_remix_inputs(
        C + n_mats, 64, 80, C, 6 if C >= 6 else C, extreme=extreme,
        edges=edges)]
    before = frame_remix.launches
    got = frame_remix(*args, n_mats)
    assert frame_remix.launches == before + 1
    ref = apply_output_stage_reference(
        rematrix_frames_reference(*args[:8], n_mats), args[8], args[9])
    assert torch.equal(got, ref)


def test_segmented_decode_on_card(dev, tmp_path):
    """``iter_packed`` over manifest segments on the card equals the
    track's ``read_all_packed()``, every segment through K1 and K234n; the
    segment-backed pulls and ranges equal slices of the whole decode."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=96, seed=3,
                         fir_across_restart=False, params_update_prob=0.0)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                        pcm_frames=cfg.total_pcm_frames, sample_rate=96000,
                        channel_assignment=17)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])

    def reader():
        return (open_disc(layout.path, config=DecodeConfig(device="cuda"))
                .open_titleset(1).open_title(1).open_track(1).open_reader())

    whole = reader().read_all_packed()
    samples = reader().read_all()
    per = cfg.frames_per_mlp_frame
    before = (chunk_filter.launches, output_stage.narrow_launches,
              decode_segment.spec_fallbacks)
    chunks = list(reader().iter_packed(16 * per))
    assert len(chunks) == 6 and b"".join(chunks) == whole
    # every segment decoded on the card (its uniform chunks by K1a), none
    # on the host's spec decoder
    assert decode_segment.spec_fallbacks == before[2]
    assert chunk_filter.launches >= before[0] + 6
    assert output_stage.narrow_launches >= before[1] + 6
    r = reader()
    assert r.manifest.total_frames == cfg.n_frames
    assert r.seek(20 * per + 3) == 20 * per + 3
    assert np.array_equal(r.read(50 * per), samples[20 * per + 3:70 * per + 3])
    assert np.array_equal(r.read_range(7 * per, 30 * per),
                          samples[7 * per:37 * per])
    assert "_decoded" not in r.__dict__


@pytest.mark.parametrize("case", FRAME_REMIX_EDGES, ids=lambda c: c[0])
def test_frame_remix_kernel_edge_cases(dev, case):
    """K9 at ``testutil.FRAME_REMIX_EDGES`` (channels and noise at the
    case's offsets: the element path where they are not aligned)."""
    args, n_mats = frame_remix_edge_args(case, dev)
    before = frame_remix.launches
    got = frame_remix(*args, n_mats)
    assert frame_remix.launches == before + 1
    ref = apply_output_stage_reference(
        rematrix_frames_reference(*args[:8], n_mats), args[8], args[9])
    assert torch.equal(got, ref)


def test_frame_remix_rejects_bad_arguments(dev):
    args = [torch.from_numpy(a).to(dev)
            for a in frame_remix_inputs(0, 4, 8, 8, 6)]
    with pytest.raises(TypeError, match="bypassed"):
        frame_remix(*args[:7], args[7].to(torch.int16), *args[8:])
    wide = [torch.from_numpy(a).to(dev)
            for a in frame_remix_inputs(0, 4, 8, 9, 6)]
    with pytest.raises(ValueError, match="1..8 channels"):
        frame_remix(*wide)


def test_decode_step_on_card(dev):
    """K1 then K9 on example_batch, against the same batch on the CPU; the
    one-device sharded step equals it."""
    batch = example_batch(F=64, C=8, NB=4, S=40, seed=11, device=dev)
    counters = (mlp_filter_blocks_tl, frame_remix)
    before = [fn.launches for fn in counters]
    torch.cuda.set_sync_debug_mode("error")  # the step never waits
    try:
        got = decode_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 1]
    cpu = example_batch(F=64, C=8, NB=4, S=40, seed=11, device="cpu")
    assert torch.equal(got.cpu(), decode_step(cpu))
    step = make_sharded_step(make_mesh(1))
    assert torch.equal(step(batch), got)


def test_decode_step_records_only_its_kernels(dev):
    """Under the profiler a step on the card is K1 (frame-major output,
    zero states) and K9: no other kernel, copy or fill; so is the
    sharded step on a 1 x 1 grid, which returns K9's output itself."""
    batch = example_batch(F=64, C=8, NB=4, S=40, seed=12, device=dev)
    step = make_sharded_step(make_mesh(1))
    for fn in (decode_step, step):
        fn(batch)
        share, detail = device_idle_share(lambda: fn(batch))
        assert detail["reason"] is None, detail
        assert detail["records"] == {"mlp_filter_kernel": 1,
                                     "frame_remix_kernel": 1}, detail


def test_unfused_chunk_on_card(dev):
    """A chunk whose substreams differ in block geometry: one K1a launch
    per substream, each writing its lanes at their columns of the series
    K234 reads; under the profiler 2 x K1a + K234 and nothing else; equal
    to the CPU's chunk program."""
    arenas, spec = unfused_chunk_inputs()
    a = ne.arenas_to_device(*arenas, spec, dev)
    want = ne.uniform_arena_pipeline(*ne.arenas_to_device(*arenas, spec,
                                                          "cpu"), spec)
    got = ne.uniform_arena_pipeline(*a, spec)
    assert torch.equal(got.cpu(), want)
    before = (chunk_filter.launches, chunk_filter.joined)
    share, detail = device_idle_share(
        lambda: ne.uniform_arena_pipeline(*a, spec))
    assert (chunk_filter.launches, chunk_filter.joined) == (
        before[0] + 2, before[1] + 1)
    assert detail["reason"] is None, detail
    assert detail["records"] == {"mlp_filter_arena_kernel": 2,
                                 "output_stage_kernel": 1}, detail


def test_engine_decode_on_card(dev, tmp_path):
    """``use_native=False``: the batched engine (planner, K1, K9) on the
    card against the port's CPU decode of the same disc."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         sample_rate=96000, n_frames=48, seed=2,
                         fir_across_restart=False, params_update_prob=0.3)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                        pcm_frames=cfg.total_pcm_frames, sample_rate=96000,
                        channel_assignment=17)
    layout = build_disc(str(tmp_path / "AUDIO_TS"), [[spec]])

    def read(device):
        reader = (open_disc(layout.path, config=DecodeConfig(
            device=device, use_native=False)).open_titleset(1).open_title(1)
            .open_track(1).open_reader())
        return reader.read_all_packed(), reader.decode_info

    counters = (mlp_filter_blocks_tl, frame_remix)
    before = [fn.launches for fn in counters]
    got, info = read("cuda")
    assert info == {"path": "engine"}
    assert all(fn.launches > b for fn, b in zip(counters, before))
    assert got == read("cpu")[0]


def test_c_api_on_card(dev, tmp_path, monkeypatch):
    """``dvda_open`` ... ``dvda_read`` on the default device (the card):
    every read equal to the CPU decode, K1 and K234n launched."""
    import dvda_tpu_torch as dt

    layout = _mix_disc(str(tmp_path / "AUDIO_TS"))
    monkeypatch.delenv("DVDA_TPU_TORCH_DEVICE", raising=False)
    want = (open_disc(layout.path, config=DecodeConfig(device="cpu"))
            .open_titleset(1).open_title(1).open_track(2).open_reader()
            .read_all())
    title = dt.dvda_open_title(dt.dvda_open_titleset(
        dt.dvda_open(layout.path), 1), 1)
    reader = dt.dvda_open_track_reader(dt.dvda_open_track(title, 2))
    assert dt.dvda_codec(reader) == dt.DVDA_MLP
    before = (chunk_filter.launches, output_stage.narrow_launches)
    got = []
    while True:
        block = dt.dvda_read(reader, 1000)
        if block.shape[0] == 0:
            break
        got.append(block)
    assert chunk_filter.launches > before[0]
    assert output_stage.narrow_launches > before[1]
    assert len(got) == -(-want.shape[0] // 1000)
    assert np.array_equal(np.concatenate(got), want)


def test_callable_source_cppm_on_card(dev, tmp_path):
    """An encrypted disc served by a callback through ``SourceAOBReader``
    with the port's CPPM hook: K7 launched, every track equal to the CPU
    decode of the plaintext disc."""
    from dvda_tpu_torch.container.sources import (CallableSectorSource,
                                                  SourceAOBReader)

    layout = _mix_disc(str(tmp_path / "AUDIO_TS"))
    cpu = DecodeConfig(device="cpu")
    title = open_disc(layout.path, config=cpu).open_titleset(1).open_title(1)
    want = [title.open_track(n).open_reader().read_all_packed()
            for n in (1, 2, 3)]
    raw = np.fromfile(os.path.join(layout.path, "ATS_01_1.AOB"),
                      dtype=np.uint8).reshape(-1, 2048)
    blob = encrypt_sectors_batch(raw, *KEYS).tobytes()
    cuda = DecodeConfig(device="cuda")
    dec = CppmDecryptor(*KEYS, config=cuda)
    before = decrypt_sectors_device.launches
    for n in (1, 2, 3):
        src = SourceAOBReader([CallableSectorSource(
            raw.shape[0], lambda first, k: blob[first * 2048:
                                                (first + k) * 2048])],
            decrypt=dec.decrypt_sectors)
        got = TrackReader(src, title.open_track(n), config=cuda)
        assert got.read_all_packed() == want[n - 1], n
    assert decrypt_sectors_device.launches > before


def test_bench_config_on_card(dev, monkeypatch):
    """The bench's headline config at a small size on the card: both modes
    equal to the host path, the link probed, the chunk program timed and
    the idle share measured or its reason given."""
    from dvda_tpu_torch.cli import bench

    monkeypatch.delenv("DVDA_TPU_TORCH_DEVICE", raising=False)
    results, summary = bench.collect(frozenset({"mlp_51_96k"}),
                                     {"mlp_51_96k": 0.5}, reps=2)
    assert summary["device"]["platform"] == "gpu"
    assert summary["d2h"] > 0 and summary["devx"] > 0
    for name in ("mlp_51_96k", "mlp_51_devhuff"):
        entry = results[name]
        assert entry["bytes_equal_host"] and entry["ours_x_realtime"] > 0
        assert entry["device_compute_x_realtime"] > 0
        assert len(entry["run_probe_MBps"]) == 2
    head = results["mlp_51_96k"]
    assert head["device_idle_share"] is not None \
        or head["device_idle_share_reason"]


@pytest.mark.parametrize("huffman", [False, True])
def test_numpy_builder_pinned_on_card(dev, huffman):
    """The numpy arena builder's pinned arenas (``native_pack=False``) hold
    ``mp_pack``'s bytes, upload to the card and run the chunk program to
    the same output; a ``native_pack=False`` decode on the card equals
    host-complete."""
    from dvda_tpu_torch.codecs.mlp import native_engine as ne

    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=40, restart_every=4, major_sync_every=4,
                         blocks_per_frame=2, block_size=24, seed=9,
                         fir_across_restart=False, params_update_prob=0.0)
    stream = synth_mlp_stream(cfg)
    inc = host.parse_mlp_stream_begin(stream, skip_values=huffman,
                                      sub_every=8 if huffman else 0)
    try:
        inc.step(0)
        v = inc.view()
        subs = [(v.sub[s], 0, int(v.sub[s]["len"][0]),
                 int(ne.restart_chains(v.sub[s], int(v.sub[s]["NB"]))[1][0]),
                 0) for s in range(2)]
        nc = subs[0][0]["NB"] // subs[0][3] - 1
        period = subs[0][2] * subs[0][3]
        args = (v, subs, 0, nc, 16, period, int(v.frame_len[0]), 6, 24, 0,
                0, 6)
        outs = []
        for native in (False, True):
            (a4, a2, a1), spec = ne._build_chunk_arenas(
                *args, pin=True, huffman=huffman, native=native)
            assert all(t.is_pinned() for t in (a4, a2, a1))
            outs.append((a4, a2, a1, spec))
    finally:
        inc.close()
    (p4, p2, p1, pspec), (n4, n2, n1, nspec) = outs
    assert pspec == nspec
    assert all(torch.equal(a, b) for a, b in ((p4, n4), (p2, n2), (p1, n1)))
    words = ne._shared_words(stream, dev) if huffman else None
    got = [ne.uniform_arena_pipeline(
        *ne.arenas_to_device(a4, a2, a1, spec, dev), spec, words)
        for a4, a2, a1, spec in outs]
    assert torch.equal(got[0], got[1])
    params = StreamParameters(BPS_CODE[24], 0xF, RATE_CODE[cfg.sample_rate],
                              0xF, 17)
    bnd = np.zeros(0, np.int64)
    out = decode_native(stream, bnd, len(stream), params, True,
                        DecodeConfig(device="cuda", device_huffman=huffman,
                                     native_pack=False, chunk_chains=2))
    hc = ne.decode_host_complete(stream, bnd, len(stream), params, True)
    assert np.array_equal(out, hc)

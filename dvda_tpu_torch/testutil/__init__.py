"""Inputs for the port's tests and ``chip_smoke.py``.

Synthetic discs come from the disc and MLP stream builders in
``testutil.synth`` and ``testutil.mlp_synth`` (copies of dvda_tpu's),
re-exported here.  :func:`filter_inputs` and :func:`output_stage_inputs` make
seeded random inputs for kernels K1 and K234 in their call layouts, and
:func:`huffman_inputs` and :func:`huffman_worst_case` (the widest
symbols) those of kernel K5, :func:`general_inputs` the tables of the
general path (K6a, K1, K6b), at K6b's edges with :data:`SERIES_REMIX_EDGES`,
and :func:`frame_remix_inputs` those of kernel K9, at its edges with
:data:`FRAME_REMIX_EDGES`.  :func:`encrypt_sectors_batch` CPPM-encrypts
a disc's sectors (the inverse of kernel K7), vectorised across sectors,
:func:`cppm_sector_mix` adds the edge cases of K7's CCI walk, and
:func:`c2_edge_batch` lays them out at the batch sizes of
:data:`C2_EDGES`.  :data:`PCM_EDGES` are kernel K8's chunk counts.
:func:`chunk_lanes_inputs` builds chunk arenas and their spec for kernels
K10 and K1a at :data:`CHUNK_LANES_EDGES`, and
:func:`chunk_filter_staging_inputs` the edges of K1a's residual staging.
:func:`host_track_bytes` is the port's C++ host path, the witness the
device path is held against.
"""

from __future__ import annotations

import numpy as np

from ..cppm.c2 import SBOX
from ..cppm.c2 import _F_vec as _c2_F
from ..cppm.decrypt import CppmDecryptor
from .host_path import host_track_bytes
from .mlp_synth import MlpSynthConfig, synth_mlp_stream
from .synth import (BPS_CODE, RATE_CODE, MlpTrackSpec, PcmTrackSpec,
                    build_disc)

__all__ = ["MlpSynthConfig", "synth_mlp_stream", "MlpTrackSpec",
           "PcmTrackSpec", "build_disc", "BPS_CODE", "RATE_CODE",
           "filter_inputs", "output_stage_inputs", "frame_remix_inputs",
           "narrow_stage_inputs", "NARROW_EDGES", "NARROW_RANGES",
           "huffman_inputs", "huffman_worst_case", "huffman_edge_inputs",
           "FILTER_EDGES", "HUFFMAN_EDGES", "general_inputs",
           "SERIES_REMIX_EDGES", "FRAME_REMIX_EDGES", "frame_remix_offsets",
           "frame_remix_edge_args",
           "encrypt_sectors_batch",
           "cppm_sector_mix", "C2_EDGES", "c2_edge_batch", "PCM_EDGES",
           "CHUNK_LANES_EDGES", "chunk_lanes_inputs",
           "chunk_filter_staging_inputs", "host_track_bytes"]


def filter_inputs(seed: int, B: int, NB: int, S: int, extreme: bool = False,
                  states: bool = False) -> tuple:
    """Arguments of ``mlp_filter_blocks_tl`` as numpy arrays (residuals
    time-leading ``[NB, S, B]``).  The default pattern has audio-like
    magnitudes and ragged block lengths; ``extreme`` spans the whole int32
    residual range and 16-bit taps (the limb-arithmetic stress pattern of
    tests/test_pallas_filter.py), and ``extreme=2`` full-range int32 taps as
    well (sums that wrap int64); ``states`` gives nonzero initial states."""
    rng = np.random.default_rng(seed)
    if extreme:
        tap = 2**31 if extreme == 2 else 2**15
        res = rng.integers(-2**31, 2**31 - 1, (B, NB, S))
        fir = rng.integers(-tap, tap, (B, NB, 8))
        iir = rng.integers(-tap, tap, (B, NB, 8))
        shift = rng.integers(0, 16, (B, NB))
        quant = rng.integers(0, 16, (B, NB))
        irst = rng.random((B, NB)) < 0.5
        init = rng.integers(-2**28, 2**28, (B, NB, 8))
        blen = np.full((B, NB), S)
    else:
        res = rng.integers(-3000, 3000, (B, NB, S))
        fir = rng.integers(-900, 900, (B, NB, 8))
        iir = rng.integers(-900, 900, (B, NB, 8))
        shift = rng.integers(8, 13, (B, NB))
        quant = rng.integers(0, 3, (B, NB))
        irst = rng.random((B, NB)) < 0.3
        init = rng.integers(-5000, 5000, (B, NB, 8))
        blen = np.where(rng.random((B, NB)) < 0.2, S // 2, S)
    st = (rng.integers(-2**20, 2**20, (2, B, 8)) if states
          else np.zeros((2, B, 8)))
    i32 = np.int32
    return (np.ascontiguousarray(res.astype(i32).transpose(1, 2, 0)),
            fir.astype(i32), iir.astype(i32), shift.astype(i32),
            quant.astype(i32), irst, init.astype(i32), blen.astype(i32),
            st[0].astype(i32), st[1].astype(i32))


#: valid codebook-1 codes, incl. the longest (9-bit) classes, and valid
#: codebook-3 codes, incl. the 1-bit short prefix
_CB1_CODES = ("111", "100", "000000001", "010000001", "011", "01001", "001")
_CB3_CODES = ("1", "001", "010000001", "0001")


def huffman_worst_case(align: int, seed: int = 11, n_words: int = 256) -> dict:
    """A hand-built residual bitstream of the widest symbols K5 decodes:
    per sample a 6-bit bypass burst, then channel 0 a codebook-1 code plus
    24 LSB bits (up to 39 bits from the sample start) and channel 1 a
    codebook-3 code plus 12 LSB bits; 3 blocks of 8 samples in sub-lanes of
    4, block 0 starting at bit ``align`` (the case of
    tests/test_huffman_device.py:254-317).  Returns the stream bytes, the
    big-endian words zero-padded to ``n_words``, and the decode tables in
    the call layout of ``decode_residuals_device`` (plus ``byp_mask``)."""
    rng = np.random.default_rng(seed)
    n_ch, NB, S0, k = 2, 3, 8, 4
    bits = "1" * align
    res_bitpos, sub_rel = [], []

    def rand_bits(n):
        return "".join(rng.choice(["0", "1"], n))

    for _ in range(NB):
        res_bitpos.append(len(bits))
        rel = []
        for i in range(S0):
            if i % k == 0:
                rel.append(len(bits) - res_bitpos[-1])
            bits += rand_bits(6)
            bits += str(rng.choice(_CB1_CODES)) + rand_bits(24)
            bits += str(rng.choice(_CB3_CODES)) + rand_bits(12)
        sub_rel.append(rel)
    stream = bytes(int(bits[i : i + 8].ljust(8, "0"), 2)
                   for i in range(0, len(bits), 8))
    buf = np.zeros(n_words * 4, np.uint8)
    buf[: len(stream)] = np.frombuffer(stream, np.uint8)

    def tile(row):
        return np.tile(np.array([row], np.int32), (NB, 1))

    return dict(
        stream=stream, words=buf.view(">u4").astype(np.uint32),
        bitpos=(np.array(res_bitpos, np.int32)[:, None]
                + np.array(sub_rel, np.int32)),
        codebook=tile([1, 3]), lsb_bits=tile([24, 12]),
        offset=tile([-5, 3]), quant=tile([2, 0]),
        nbyp=np.full(NB, 6, np.int32), byp_mask=np.full(NB, 0x3F, np.int32),
        res_bitpos=np.array(res_bitpos, np.int32), S0=S0, J=n_ch + 1, k=k)


def huffman_inputs(seed: int, L: int, nsub: int, C: int, S0: int, k: int,
                   burst: bool) -> dict:
    """Arguments of ``decode_residuals_device`` as numpy arrays (plus the
    burst slot map ``bypk``/``bypv``) over random stream words: decode
    tables in the parser's ranges (incl. lsb_bits 0 and 24, negative
    offsets under quant > 0), start bits on and off word boundaries behind
    a word base of 64, bursts of 0..6 bits."""
    rng = np.random.default_rng(seed)
    W, base = 2048, 64
    words = rng.integers(0, 2**32, W, dtype=np.uint64).astype(np.uint32)
    bitpos = rng.integers(0, (W - base - 64) * 32, (L, nsub))
    bitpos[::3] &= ~31                        # b == 0 alignments
    nbyp = rng.integers(0, 7, L) if burst else np.zeros(L, np.int64)
    nbyp[::4] = 0
    mask = rng.integers(0, 64, L)
    bits = (mask[:, None] >> np.arange(6)) & 1
    i32 = np.int32
    return dict(
        words=words, word_base=base, bitpos=bitpos.astype(i32),
        codebook=rng.integers(0, 4, (L, C)).astype(i32),
        lsb_bits=rng.choice([0, 1, 5, 12, 23, 24], (L, C)).astype(i32),
        offset=rng.integers(-2**20, 2**20, (L, C)).astype(i32),
        quant=rng.integers(0, 8, (L, C)).astype(i32), nbyp=nbyp.astype(i32),
        bypk=(np.cumsum(bits, 1) - bits).astype(np.int8),
        bypv=bits.astype(np.int8), S0=S0, J=C + (1 if burst else 0), k=k)


#: K1 edge shapes (B, NB, S, extreme, states) for :func:`filter_inputs`:
#: lane counts off the kernel's 32-lane block and off a multiple of 4 (its
#: 4-byte staging copy), NB = 1, S = 1 (block lengths 1 and 0), S of 7, 33
#: and 100 (off and across its 32-row tiles), blocks shorter than S and
#: mid-chain IIR resets (every pattern), the extreme-value pattern, and
#: full-range taps (extreme=2: sums that wrap int64); S of 34, 38, 28 and
#: 46 put block_len (S // 2) 1, 3, 6 and 7 samples into an 8-sample group
FILTER_EDGES = (
    (33, 3, 40, False, True), (100, 1, 40, False, False),
    (64, 5, 1, False, True), (70, 4, 7, True, True),
    (96, 2, 100, False, True), (40, 6, 33, True, False),
    (1, 3, 5, False, True), (48, 3, 40, 2, True),
    (36, 3, 34, False, True), (40, 3, 38, False, False),
    (64, 2, 28, False, True), (40, 3, 46, False, True),
)

#: K5 edge cases (name, seed, L, nsub, C, S0, k, NB0, burst, slots, layout)
#: for :func:`huffman_edge_inputs`: ``chains`` lays the sub-lanes' start
#: bits out in order as a stream does (every block's window fits), with a
#: ragged last block of chains; ``mixed`` spreads the start bits of the
#: chains past the first 8 over more words than a block stages (those
#: blocks read device memory); ``corrupt`` puts lsb_bits of 40 and -3 in
#: the first block (no bound: it reads device memory); ``outside`` starts
#: before word 0 and reads past the last word; nsub > 1 (split), NB0 == 0,
#: C = 8 and C = 9 (the kernel's runtime-width body)
HUFFMAN_EDGES = (
    ("fits", 1, 16 * 12, 1, 4, 40, 40, 16, True, True, "chains"),
    ("mixed", 2, 16 * 20, 1, 2, 40, 40, 16, True, False, "mixed"),
    ("corrupt", 3, 16 * 16, 1, 6, 40, 40, 16, True, False, "corrupt"),
    ("outside", 4, 16 * 3, 1, 2, 40, 40, 16, True, True, "outside"),
    ("split", 5, 16 * 9, 5, 4, 40, 8, 16, True, True, "chains"),
    ("nb0zero", 6, 300, 2, 3, 16, 8, 0, False, False, "chains"),
    ("c8", 7, 16 * 2, 1, 8, 40, 40, 16, True, True, "chains"),
    ("c9", 8, 16, 1, 9, 20, 20, 16, True, False, "chains"),
)


def huffman_edge_inputs(edge: tuple) -> dict:
    """The arguments of one :data:`HUFFMAN_EDGES` case, as
    :func:`huffman_inputs` gives them (plus ``NB0`` and ``slots``), with
    start bits laid out by the case's ``layout``."""
    name, seed, L, nsub, C, S0, k, NB0, burst, slots, layout = edge
    case = huffman_inputs(seed, L, nsub, C, S0, k, burst)
    rng = np.random.default_rng(seed + 100)
    # in order, lane by lane and sub-lane by sub-lane, as a stream is
    gaps = rng.integers(k * C * 4, k * C * 12, L * nsub)
    pos = np.cumsum(gaps) - gaps[0]
    pos[::3] &= ~31                           # b == 0 alignments
    W = int(pos[-1]) // 32 + 64
    base = 16
    if layout == "mixed":  # chains past the first 8 at random over 32 K words
        W = 32768
        chain_lanes = (NB0 or 1) * 8 * nsub
        far = rng.integers(0, (W - base - 64) * 32, L * nsub)
        far[chain_lanes] = 0
        far[-1] = (W - base - 64) * 32
        pos = np.where(np.arange(L * nsub) < chain_lanes, pos, far)
    elif layout == "corrupt":
        case["lsb_bits"][3, 1] = 40
        case["lsb_bits"][7, 0] = -3
    elif layout == "outside":  # from before word 0 to past the last word
        base = 0
        pos = pos - 3000
        W = int(pos[-1]) // 32 - 4
    case["words"] = rng.integers(0, 2**32, W, dtype=np.uint64).astype(
        np.uint32)
    case["word_base"] = base
    case["bitpos"] = pos.reshape(L, nsub).astype(np.int32)
    case.update(name=name, NB0=NB0, slots=slots)
    return case


#: Chunk edge cases (name, per substream (n_ch, NB0, S0), Bc, per-chain
#: parameters, device-Huffman tables, residual width, zero trailing
#: chains) for :func:`chunk_lanes_inputs`: two substreams fused on the
#: lane axis with per-chain and with per-block parameters, two of
#: different (NB0, S0) (two filter launches), a partial chunk (zero
#: trailing chains), int32 residuals, one lane of one sample, and the
#: device-Huffman tables fused, per block and unfused.  K1a (the filter
#: reading the arenas) runs at every case: its 32-lane blocks straddle
#: the substreams' and channels' lane boundaries, its 32-row tiles the
#: blocks (S0 of 1, 9, 10, 17, 20, 24, 33 and 40), and its residual
#: arenas are int8, int16 and int32; K10 (K5's inputs) at the
#: device-Huffman ones
CHUNK_LANES_EDGES = (
    ("fused", ((2, 4, 40), (4, 4, 40)), 40, True, False, 2, 0),
    ("per_block", ((2, 4, 40), (4, 4, 40)), 33, False, False, 2, 0),
    ("unfused", ((2, 4, 10), (4, 2, 20)), 33, True, False, 2, 0),
    ("partial", ((2, 3, 24), (4, 3, 24)), 37, True, False, 2, 5),
    ("int32_res", ((6, 2, 33),), 31, False, False, 4, 0),
    ("int8_res", ((3, 3, 17), (1, 3, 17)), 35, True, False, 1, 2),
    ("tiny", ((1, 1, 1),), 1, True, False, 2, 0),
    ("huffman", ((2, 4, 40), (4, 4, 40)), 40, True, True, 0, 3),
    ("huffman_per_block", ((2, 4, 40), (4, 4, 40)), 33, False, True, 0, 0),
    ("huffman_unfused", ((2, 4, 10), (4, 2, 20)), 9, True, True, 0, 0),
)


def chunk_lanes_inputs(case: tuple, seed: int = 0, filter_domain=False):
    """((a4, a2, a1), spec): numpy chunk arenas for a
    :data:`CHUNK_LANES_EDGES` case, laid out by the port's arena builder
    behind a few arrays of the chunk's frame tables (so that every
    substream array sits at an offset), each substream's arrays at random
    values over their dtype's whole range (sign extension), iir_reset at
    0, 1, -1 and 5; the trailing chains zero.  ``filter_domain`` keeps
    shift in 0-39 and quant in 0-31, where C's shifts (the filter's
    arithmetic) are defined: shifts of 32-39 take the filter's one-sample
    step."""
    from ..codecs.mlp.native_engine import _ArenaBuilder

    name, geometry, Bc, per_chain, huffman, res_width, zero = case
    rng = np.random.default_rng(seed + CHUNK_LANES_EDGES.index(case))

    def rand(dtype, shape, hi=None):
        info = np.iinfo(dtype)
        x = (rng.integers(0, hi, shape, dtype=dtype) if hi else
             rng.integers(info.min, info.max, shape, dtype=dtype,
                          endpoint=True))
        x[Bc - zero:] = 0
        return x

    b = _ArenaBuilder()
    b.add("mat_coeff", rand(np.int16, (3, 6, 8)))
    b.add("mat_out", rand(np.int8, (3, 6)))
    b.add("frame_seed", rand(np.int32, (3,)))
    if huffman:
        b.add("wordbase", np.asarray(7, np.int32))
    for s, (n_ch, NB0, S0) in enumerate(geometry):
        if huffman:
            nsub = 1 + 2 * s
            b.mark(f"s{s}_k", -(-S0 // nsub))
            b.add(f"s{s}_bitpos", rand(np.int32, (Bc, NB0, nsub)))
            b.mark(f"s{s}_NW", 32)
            b.add(f"s{s}_cb", rand(np.int8, (Bc, NB0, n_ch)))
            b.add(f"s{s}_lsbb", rand(np.int8, (Bc, NB0, n_ch)))
            b.add(f"s{s}_off", rand(np.int32, (Bc, NB0, n_ch)))
            b.add(f"s{s}_nbyp", rand(np.int8, (Bc, NB0)))
            b.mark(f"s{s}_S", S0)
            b.mark(f"s{s}_J", n_ch + 1)
        else:
            b.add(f"s{s}_res", rand({1: np.int8, 2: np.int16,
                                     4: np.int32}[res_width],
                                    (Bc, NB0, n_ch, S0)))
        rows = (Bc, n_ch) if per_chain else (Bc, NB0, n_ch)
        sfx = "_c" if per_chain else ""
        for pname, inner, dtype, hi in (("rc_fir", (8,), np.int16, None),
                                        ("rc_iir", (8,), np.int16, None),
                                        ("iir_init", (8,), np.int32, None),
                                        ("shift", (), np.int8, 40),
                                        ("quant", (), np.int8, 32)):
            b.add(f"s{s}_{pname}{sfx}",
                  rand(dtype, rows + inner, hi if filter_domain else None))
        reset = rng.choice(np.array([0, 1, -1, 5], np.int8), rows)
        reset[Bc - zero:] = 0
        b.add(f"s{s}_iir_reset{sfx}", reset)
    return b.finish()


def chunk_filter_staging_inputs(case: tuple, layout: str):
    """:func:`chunk_lanes_inputs` (``filter_domain``) for kernel K1a's
    residual staging: ``"res_last"`` moves the last substream's residuals
    to the end of their arena (a copy appended after a few zeros, the spec
    pointed at it), so that their last 16-byte granule runs past the
    arena's end; ``"unaligned"`` puts each arena one element past a
    16-byte boundary (the staging then loads one row at a time);
    ``"wide_params"`` moves every parameter array to int32 copies at the
    end of the int32 arena (K1a's variant for any widths)."""
    arenas, spec = chunk_lanes_inputs(case, filter_domain=True)
    arenas = list(arenas)
    if layout == "wide_params":
        params = ("rc_fir", "rc_iir", "iir_init", "shift", "quant",
                  "iir_reset")
        moved = []
        for e in spec:
            if (e[4] != "flag" and e[0][0] == "s"
                    and e[0].split("_", 1)[1].removesuffix("_c") in params):
                k = {4: 0, 2: 1, 1: 2}[e[1]]
                n = int(np.prod(e[3]))
                x = arenas[k][e[2]:e[2] + n].astype(np.int32)
                e = (e[0], 4, arenas[0].size, e[3], "int32")
                arenas[0] = np.concatenate([arenas[0], x])
            moved.append(e)
        spec = tuple(moved)
    elif layout == "res_last":
        name = max(e[0] for e in spec if e[0].endswith("_res"))
        entry = next(e for e in spec if e[0] == name)
        k = {4: 0, 2: 1, 1: 2}[entry[1]]
        n = int(np.prod(entry[3]))
        tail = arenas[k][entry[2]:entry[2] + n]
        pad = next(p for p in range(1, 16)
                   if (arenas[k].size + p + n) * entry[1] % 16)
        arenas[k] = np.concatenate([arenas[k], np.zeros(pad, tail.dtype),
                                    tail])
        spec = tuple((e[0], e[1], arenas[k].size - n, e[3], e[4])
                     if e[0] == name else e for e in spec)
    elif layout == "unaligned":
        for k, a in enumerate(arenas):
            buf = np.empty(a.size + 16 // a.itemsize, a.dtype)
            arenas[k] = buf[1:1 + a.size]
            arenas[k][:] = a
    else:
        raise ValueError(layout)
    return tuple(arenas), spec


def output_stage_inputs(seed: int, chains: int, fpc: int, L0: int,
                        C_tot: int, C_out: int, n_active: int = 6,
                        extreme: bool = False) -> dict:
    """Positional arguments of ``output_stage`` as numpy arrays in the
    arena's dtypes and chain-major layouts, for ``chains`` chains of ``fpc``
    frames of ``L0`` samples.  Matrix slots ``>= n_active`` are inactive.
    ``extreme`` spans the whole int32 sample range, 16-bit coefficients
    and large shifts; otherwise magnitudes are 24-bit-audio-like."""
    rng = np.random.default_rng(seed)
    F, T = chains * fpc, chains * fpc * L0
    if extreme:
        series = rng.integers(-2**31, 2**31, (fpc * L0, C_tot * chains))
        coeff = rng.choice([-2**15, -2**15 + 1, -1, 0, 1, 2**15 - 1],
                           (F, 6, 8))
        noise = rng.integers(-2**15, 2**15, (F, 6, 2))
        out_shift = rng.choice([0, 1, 7, 31], (F, 8))
        quant = rng.integers(0, 16, (F, 6))
        mat_out = rng.integers(0, 8, (F, 6))
    else:
        series = rng.integers(-2**23, 2**23, (fpc * L0, C_tot * chains))
        coeff = rng.integers(-2**14, 2**14, (F, 6, 8))
        noise = rng.integers(-2**10, 2**10, (F, 6, 2))
        out_shift = rng.integers(0, 3, (F, 8))
        quant = rng.integers(0, 4, (F, 6))
        mat_out = rng.integers(0, C_tot, (F, 6))
    active = rng.random((F, 6)) < 0.8
    active[:, n_active:] = False
    return dict(
        series=series.astype(np.int32),
        frame_seed=rng.integers(0, 2**32, F, dtype=np.uint64)
        .astype(np.uint32).view(np.int32),
        frame_nshift=rng.integers(0, 16 if extreme else 9, F).astype(np.int8),
        byp=rng.integers(-128, 128, T).astype(np.int8),
        mat_coeff=coeff.astype(np.int16),
        mat_noise=noise.astype(np.int16),
        mat_out=mat_out.astype(np.int8),
        mat_active=active.astype(np.int8),
        mat_quant=quant.astype(np.int8),
        out_shift=out_shift.astype(np.int8),
        wave_perm=rng.permutation(max(C_tot, C_out))[:C_out].astype(np.int8))


#: K234 edge shapes (chains, fpc, L0, C_tot, C_out, n_mats, nbytes,
#: extreme) for :func:`output_stage_inputs`: chain counts off the kernel's
#: 32-chain tile and on it (1, 3, 5, 7, 31, 33, 40, 64), frame lengths off
#: its 16-sample strip (8, 24, 40, 56, 200) and on it (80, 160: 48/96/192
#: kHz are 40, 80, 160), output runs that start off a 16-byte boundary,
#: C_tot 1 and 8, C_out below C_tot, 0-6 matrix slots, every output form,
#: the int32 extremes
OUTPUT_STAGE_EDGES = (
    (31, 3, 24, 1, 2, 2, 3, False),
    (64, 2, 8, 8, 8, 6, 3, True),
    (1, 5, 40, 6, 6, 3, 3, False),
    (40, 3, 56, 5, 4, 6, 0, True),
    (33, 2, 40, 8, 6, 6, 3, True),
    (33, 2, 80, 6, 2, 3, 2, False),
    (33, 1, 160, 4, 3, 0, 0, True),
    (5, 3, 160, 2, 1, 1, 3, False),
    (7, 2, 80, 7, 5, 4, 0, True),
    (33, 2, 40, 3, 2, 2, 2, True),
    (3, 1, 200, 8, 7, 5, 3, False),
)

#: K234n edge cases: each K234 edge shape at tier 12 (even C_out only: the
#: tier packs channel pairs) and at tier 16
NARROW_EDGES = tuple((shape, tier) for shape in OUTPUT_STAGE_EDGES
                     for tier in (12, 16) if tier == 16 or shape[4] % 2 == 0)

#: K234n's fits test at its edges: staged samples spanning [lo, hi], both
#: ends present, and the flag that gives at tier 12 and at tier 16
NARROW_RANGES = ((-2048, 2047, 3, 1), (-2049, 2048, 2, 1),
                 (-32768, 32767, 2, 1), (-32769, 32768, 0, 0))


def narrow_stage_inputs(seed: int, chains: int, fpc: int, L0: int,
                        C_tot: int, C_out: int, lo: int, hi: int) -> dict:
    """:func:`output_stage_inputs` with every matrix slot inactive and
    zero output shifts, so that the staged samples are the series' own
    values: uniform in ``[lo, hi]``, with every channel of every chain at
    ``lo`` in its first sample and at ``hi`` in its last."""
    inp = output_stage_inputs(seed, chains, fpc, L0, C_tot, C_out)
    rng = np.random.default_rng(seed)
    series = rng.integers(lo, hi + 1, inp["series"].shape)
    series[0], series[-1] = lo, hi
    inp.update(series=series.astype(np.int32),
               mat_active=np.zeros_like(inp["mat_active"]),
               out_shift=np.zeros_like(inp["out_shift"]))
    return inp


#: K6a edge shapes (n_ch, S, n_blocks, extreme) for :func:`general_inputs`
#: (one substream, seed 0): every substream width, blocks of 1..S samples
#: (S of 20, 40, and 100, past a 64-row strip), chain counts off the
#: kernel's 128-lane tile, chain positions masked off
LANE_PACK_EDGES = (
    (1, 20, 1000, False), (2, 40, 900, True), (3, 40, 600, False),
    (4, 20, 600, False), (5, 40, 400, True), (6, 20, 400, False),
    (6, 100, 300, True),
)


def _starts_long(T: int) -> list:
    """Frames longer than K6b's 512-row tile."""
    return [0, 5, 700, 1900, T]


def _starts_empty(T: int) -> list:
    """Runs of empty frames at the start, at K6b's tile edge (rows 512 and
    1024) and across it, and at the end."""
    return ([0, 0, 0, 100, 300, 510] + [512] * 4 + [515, 1020]
            + [1023] * 3 + [1030, 1500] + [T] * 3)


def _starts_dense(T: int) -> list:
    """Frames of 1-7 rows over the first 1,200 rows (more in one tile than
    the 16 a piece stages), runs of up to 20 empty frames among them
    (across a piece), then one frame to the end."""
    rng = np.random.default_rng(T)
    starts, t = [0], 0
    while t < 1200:
        t += int(rng.integers(1, 8))
        starts += [t] * (20 if len(starts) == 40 else 1)
    return starts + [T]


def _starts_one(T: int) -> list:
    return [0, T]


#: K6b edge cases (name, n_ch, n_blocks, S, extreme, frame_starts) for
#: :func:`general_inputs` (seed 0): T off the kernel's 512-row tile
#: (2,000-2,600 rows), frames longer than a tile, runs of empty frames (at
#: the start, at and across a tile edge, at the end), more frames in one
#: tile than a 16-frame piece holds, one frame only, one and two
#: substreams, the int32 extremes
SERIES_REMIX_EDGES = (
    ("long", (2, 4), 120, 40, False, _starts_long),
    ("empty", (6,), 120, 40, True, _starts_empty),
    ("dense", (2, 4), 120, 40, True, _starts_dense),
    ("one", (2, 4), 110, 40, False, _starts_one),
    ("long-1sub", (5,), 100, 40, True, _starts_long),
    ("dense-1sub", (3,), 130, 40, False, _starts_dense),
)


#: K9 edge cases (name, F, L, C, C_out, n_mats, extreme, edges, offset)
#: for :func:`frame_remix_inputs` (seed: the case's index): F*L off the
#: kernel's 256-row tile; L of 1 (a tile of 256 frames, 16 staged
#: pieces), 12 (up to 23 frames a tile: two pieces), 79 and 80 (frames
#: across tiles), 640 and 1,100 (longer than a tile); C of 1-8 with C_out
#: up to 8 (past C: channels repeat); n_mats of 0-6 with inactive slots
#: below n_mats (30 % of slots); the int32 extremes and the shift edges;
#: and bases offset from
#: a 64-byte boundary (``offset``: "row" moves channels, noise and output
#: by one of their rows, "elem" by one element, where the kernel takes its
#: element loads and stores)
FRAME_REMIX_EDGES = (
    ("L1", 1100, 1, 8, 6, 6, False, False, ""),
    ("L12-pieces", 60, 12, 6, 6, 5, True, False, ""),
    ("L79", 20, 79, 6, 6, 5, False, False, ""),
    ("L80-edges", 17, 80, 8, 6, 6, True, True, ""),
    ("L640", 3, 640, 8, 6, 6, False, False, ""),
    ("L1100", 2, 1100, 2, 2, 2, True, False, ""),
    ("C1", 9, 61, 1, 1, 3, True, False, ""),
    ("C3-out8", 7, 80, 3, 8, 6, True, True, ""),
    ("C4", 11, 40, 4, 4, 4, False, False, ""),
    ("C5-out2", 13, 33, 5, 2, 1, True, False, ""),
    ("C7", 5, 80, 7, 7, 6, True, False, ""),
    ("C2-nmats0", 10, 80, 2, 2, 0, False, False, ""),
    ("C6-out8", 9, 80, 6, 8, 3, True, True, ""),
    ("C8-out8", 9, 80, 8, 8, 6, True, False, ""),
    ("C8-row", 9, 79, 8, 6, 6, True, False, "row"),
    ("C6-row", 9, 79, 6, 6, 5, False, False, "row"),
    ("C2-row", 9, 79, 2, 2, 2, True, False, "row"),
    ("C8-elem", 9, 79, 8, 6, 6, True, True, "elem"),
    ("C6-elem", 9, 79, 6, 6, 5, True, False, "elem"),
)


def frame_remix_offsets(case: tuple) -> tuple:
    """Element offsets from a 64-byte boundary of (channels, noise, out)
    for a :data:`FRAME_REMIX_EDGES` case."""
    _name, _F, _L, C, C_out, *_rest, offset = case
    if offset == "row":
        return C, 2, C_out
    return (1, 1, 1) if offset == "elem" else (0, 0, 0)


def frame_remix_edge_args(case: tuple, device) -> tuple:
    """(``frame_remix``'s positional arguments as tensors on ``device``,
    ``wave_perm`` on the host; n_mats) for a :data:`FRAME_REMIX_EDGES`
    case, channels and noise at the case's offsets (the wrapper allocates
    the output, so its offset applies only in the CPU harness)."""
    import torch

    _name, F, L, C, C_out, n_mats, extreme, edges, _ = case
    args = frame_remix_inputs(FRAME_REMIX_EDGES.index(case), F, L, C, C_out,
                              extreme=extreme, edges=edges)
    out = [torch.from_numpy(a).to(device) for a in args[:9]]
    for i, k in enumerate(frame_remix_offsets(case)[:2]):
        buf = torch.empty(out[i].numel() + 16 + k, dtype=torch.int32,
                          device=device)
        start = (-(buf.data_ptr() // 4)) % 16 + k
        view = buf[start : start + out[i].numel()].view(out[i].shape)
        view.copy_(out[i])
        out[i] = view
    return out + [torch.from_numpy(args[9])], n_mats


def frame_remix_inputs(seed: int, F: int, L: int, C: int, C_out: int,
                       extreme: bool = False, edges: bool = False) -> list:
    """Positional arguments of ``frame_remix`` (all but ``n_mats``) as
    numpy arrays in dvda_tpu's frame-major layouts.  ``extreme`` spans the
    whole int32 range for channels and bypass addends, with 17-bit
    coefficients (the bound under which dvda_tpu's limb arithmetic is
    exact) and output channels up to 7 whatever C; ``edges`` draws quant
    steps and output shifts at and past XLA's 32-bit shift limit."""
    rng = np.random.default_rng(seed)
    if extreme:
        channels = rng.integers(-2**31, 2**31, (F, L, C))
        noise = rng.integers(-2**23, 2**23, (F, L, 2))
        coeff = rng.integers(-2**16, 2**16, (F, 6, C))
        ncoef = rng.integers(-2**16, 2**16, (F, 6, 2))
        bypassed = rng.integers(-2**31, 2**31, (F, 6, L))
        mat_out = rng.integers(0, 8, (F, 6))
    else:
        channels = rng.integers(-2**23, 2**23, (F, L, C))
        noise = rng.integers(-2**10, 2**10, (F, L, 2))
        coeff = rng.integers(-2**14, 2**14, (F, 6, C))
        ncoef = rng.integers(-2**12, 2**12, (F, 6, 2))
        bypassed = rng.integers(0, 2, (F, 6, L))
        mat_out = rng.integers(0, C, (F, 6))
    if edges:
        quant = rng.choice([0, 1, 31, 32, 33, 64, -1], (F, 6))
        out_shift = rng.choice([0, 2, 31, 32, 40, -5], (F, C))
    else:
        quant = rng.integers(0, 4, (F, 6))
        out_shift = rng.integers(0, 3, (F, C))
    wave_perm = (rng.permutation(C)[:C_out] if C_out <= C
                 else rng.integers(0, C, C_out))
    i32 = np.int32
    return [channels.astype(i32), noise.astype(i32), coeff.astype(i32),
            ncoef.astype(i32), mat_out.astype(i32), rng.random((F, 6)) < 0.7,
            quant.astype(i32), bypassed.astype(i32), out_shift.astype(i32),
            wave_perm.astype(i32)]


def general_inputs(seed: int, n_blocks: int = 24, S: int = 8,
                   n_ch: tuple = (2, 4), F: int = 6,
                   extreme: bool = False, frame_starts=None) -> tuple:
    """(subs, frames): numpy arguments of ``general_pipeline`` for
    synthetic parse arrays — ``n_blocks`` blocks of 1..``S`` samples,
    random restarts (some coupled, so chains differ in length), one
    substream per entry of ``n_ch``, and ``F`` frames over the samples,
    one of them empty, or the frames whose starts (with T last) the
    callable ``frame_starts(T)`` gives.  ``extreme`` takes the int32 extremes of
    tests/test_pallas_filter.py:33-50 (full-range residuals, 16-bit taps)
    and of the matrix chain (full-range coefficients and noise, output
    shifts up to 31) through the whole path."""
    from ..ops.general_gather import substream_tables

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, S + 1, n_blocks).astype(np.int32)
    lens[0] = S
    T = int(lens.sum())
    if frame_starts is not None:
        given = np.asarray(frame_starts(T), np.int64)
        F = len(given) - 1
    restart = rng.random(n_blocks) < 0.3
    restart[0] = True
    i32 = np.int32
    subs = []
    for nc in n_ch:
        if extreme:
            res = rng.integers(-2**31, 2**31 - 1, T * nc)
            taps = [rng.integers(-2**15, 2**15, (n_blocks, nc, 8))
                    for _ in range(2)]
            shift = rng.integers(0, 16, (n_blocks, nc))
            quant = rng.integers(0, 16, (n_blocks, nc))
            init = rng.integers(-2**28, 2**28, (n_blocks, nc, 8))
        else:
            res = rng.integers(-3000, 3000, T * nc)
            taps = [rng.integers(-900, 900, (n_blocks, nc, 8))
                    for _ in range(2)]
            shift = rng.integers(8, 13, (n_blocks, nc))
            quant = rng.integers(0, 3, (n_blocks, nc))
            init = rng.integers(-5000, 5000, (n_blocks, nc, 8))
        sub = {"fr_nblocks": np.array([n_blocks] + [0] * (F - 1), i32),
               "len": lens, "restart": restart,
               "fir_any": (rng.random(n_blocks) < 0.4).astype(np.uint8),
               "residuals": res.astype(i32), "rc_fir": taps[0].astype(i32),
               "rc_iir": taps[1].astype(i32), "iir_init": init.astype(i32),
               "shift": shift.astype(i32), "quant": quant.astype(i32),
               "iir_reset": rng.random((n_blocks, nc)) < 0.5}
        subs.append(substream_tables(sub, F, T))
    if frame_starts is None:
        cuts = np.sort(rng.choice(np.arange(1, T), F - 2, replace=False))
        starts = np.concatenate([[0], cuts[:1], cuts, [T]]).astype(np.int64)
    else:
        starts = given
    C = sum(n_ch)
    if extreme:
        coeff = rng.choice([-2**15, -2**15 + 1, -1, 0, 1, 2**15 - 1],
                           (F, 6, 8))
        ncoef = rng.integers(-2**15, 2**15, (F, 6, 2))
        noise = rng.integers(-2**23, 2**23, (T, 2))
        out_shift = rng.choice([0, 1, 7, 31], (F, 8))
        mquant = rng.integers(0, 16, (F, 6))
        mout = rng.integers(0, 8, (F, 6))
    else:
        coeff = rng.integers(-2**14, 2**14, (F, 6, 8))
        ncoef = rng.integers(-2**10, 2**10, (F, 6, 2))
        noise = rng.integers(-2**10, 2**10, (T, 2))
        out_shift = rng.integers(0, 3, (F, 8))
        mquant = rng.integers(0, 4, (F, 6))
        mout = rng.integers(0, C, (F, 6))
    frames = (starts, noise.astype(i32),
              rng.integers(0, 64, T).astype(np.uint8), coeff.astype(i32),
              ncoef.astype(i32), mout.astype(i32), rng.random((F, 6)) < 0.8,
              mquant.astype(i32), out_shift.astype(i32),
              rng.permutation(C).astype(i32))
    return subs, frames


def encrypt_sectors_batch(sectors: np.ndarray, media_key: int,
                          id_album_media: int) -> np.ndarray:
    """CPPM-encrypt a uint8 ``[N, 2048]`` sector batch: byte for byte what
    dvda_tpu's scalar ``cppm.decrypt.encrypt_sectors`` gives, vectorised
    across sectors (the inverse of ``c2_dcbc_dec_batch``).  Every pack
    sector gets the scrambling bit and its 1920-byte span D-CBC-encrypted;
    others pass through.  Returns a new array."""
    out = np.ascontiguousarray(sectors, dtype=np.uint8).copy()
    pack = ((out[:, 0] == 0) & (out[:, 1] == 0) & (out[:, 2] == 1)
            & (out[:, 3] == 0xBA))
    idx = np.nonzero(pack)[0]
    if idx.size == 0:
        return out
    sec = out[idx]
    sec[:, 20] |= 0x10
    dec = CppmDecryptor(media_key, id_album_media)
    key = dec._content_keys(sec)                          # uint64 [n]
    u32 = np.uint32
    key_hi = (key >> np.uint64(32)).astype(u32)
    key_lo = (key & np.uint64(0xFFFFFFFF)).astype(u32)
    words = sec[:, 128:].view(">u4").astype(u32).reshape(-1, 240, 2)
    ka, kb = key_hi, key_lo
    for w in range(240):
        rounds = 10 if w == 0 else 2
        sk, a, b = [], ka.copy(), kb.copy()
        for rnd in range(rounds):
            a &= u32(0x00FFFFFF)
            sk.append(b + (SBOX[(a & u32(0xFF)) ^ u32(rnd)] << u32(4)))
            a, b = (a << u32(17)) | (b >> u32(15)), (b << u32(17)) | (a >> u32(7))
        # encryption undoes the decrypt rounds in reverse: from the swapped
        # plaintext, step r maps (L, R) to (R + F(L, sk[r]), L); the decrypt
        # direction's round-5 state is the state before step 5
        L, R = words[:, w, 1].copy(), words[:, w, 0].copy()
        for rnd in range(10):
            if rnd == 5:
                ka = key_hi ^ (R & u32(0x00FFFFFF))
                kb = key_lo ^ L
            L, R = R + _c2_F(L, sk[rnd % rounds]), L
        words[:, w, 0], words[:, w, 1] = L, R
    sec[:, 128:] = words.reshape(idx.size, -1).astype(">u4").view(np.uint8)
    out[idx] = sec
    return out


def _pack_header(sec: np.ndarray) -> None:
    sec[:4] = (0, 0, 1, 0xBA)
    sec[13] = 0xF8  # no pack stuffing: the first PES starts at byte 14


def _pes(sec: np.ndarray, pos: int, stream_id: int, length: int) -> None:
    sec[pos : pos + 4] = (0, 0, 1, stream_id)
    sec[pos + 4], sec[pos + 5] = length >> 8, length & 0xFF


def _mark_cci(sec: np.ndarray, value: int) -> int:
    """Write ``value`` into every copy-control byte the CCI walk of
    ``CppmDecryptor._reset_cci`` would zero; returns how many."""
    marked = 0
    pos = 14 + int(sec[13] & 0x07)
    while pos + 9 <= 2048:
        if not (sec[pos] == 0 and sec[pos + 1] == 0 and sec[pos + 2] == 1):
            break
        if sec[pos + 3] == 0xBD:
            p = pos + 9 + int(sec[pos + 8])
            if p + 13 <= 2048:
                if sec[p] == 0xA0 and sec[p + 3] > 8:
                    sec[p + 12] = value
                    marked += 1
                elif sec[p] == 0xA1 and sec[p + 3] > 4:
                    sec[p + 8] = value
                    marked += 1
        pos += 6 + ((int(sec[pos + 4]) << 8) | int(sec[pos + 5]))
    return marked


def cppm_sector_mix(sectors: np.ndarray, media_key: int,
                    id_album_media: int, seed: int = 0):
    """(plaintext, encrypted) uint8 ``[N + 4, 2048]`` batches for K7 tests:
    ``sectors`` (a disc's AOB sectors) with non-zero copy-control bytes
    wherever the CCI walk looks, then two hand-built pack sectors whose
    walks run to the sector's end (the second zeroes the sector's very last
    byte), a sector that is not a pack, and one pack sector left clear
    (not scrambled) in the encrypted batch."""
    rng = np.random.default_rng(seed)
    plain = np.ascontiguousarray(sectors, dtype=np.uint8).copy()
    for sec in plain:
        _mark_cci(sec, int(rng.integers(1, 256)))
    edge = rng.integers(0, 256, (4, 2048), dtype=np.uint8)
    for sec in edge[:3]:
        sec[4:128] = 0
        _pack_header(sec)
    # a padding PES up to 2036, then a BD PES whose sub-header would end
    # past the sector: the walk stops at the end without writing
    _pes(edge[0], 14, 0xBE, 2036 - 20)
    edge[0][20] = 0x81
    _pes(edge[0], 2036, 0xBD, 0x10)
    edge[0][2044] = 3
    # ... a BD PES whose LPCM sub-header ends exactly at byte 2047
    _pes(edge[1], 14, 0xBE, 2026 - 20)
    edge[1][20] = 0x81
    _pes(edge[1], 2026, 0xBD, 0x10)
    edge[1][2034] = 0
    edge[1][2035], edge[1][2038], edge[1][2047] = 0xA0, 9, 0xEE
    # the clear pack sector: an MLP-style BD PES with its CCI byte set
    _pes(edge[2], 14, 0xBD, 200)
    edge[2][20], edge[2][22] = 0x81, 0
    edge[2][23], edge[2][26], edge[2][31] = 0xA1, 5, 0x42
    edge[3][:4] = (0x47, 0x40, 0x11, 0x10)  # not a pack
    plain = np.concatenate([plain, edge])
    enc = encrypt_sectors_batch(plain, media_key, id_album_media)
    enc[-2] = plain[-2]
    return plain, enc


#: K7 edge batches (sectors, seed) for :func:`c2_edge_batch`: one
#: sector, a 32-sector block less one, one block, a block and one, three
#: blocks and one
C2_EDGES = ((1, 1), (31, 2), (32, 3), (33, 4), (97, 5))


def c2_edge_batch(sectors: np.ndarray, n: int, media_key: int,
                  id_album_media: int, seed: int):
    """(plaintext, encrypted) uint8 ``[n, 2048]`` batches for K7 edge
    tests: rows of ``sectors`` (a disc's AOB sectors) in a seeded order,
    with :func:`cppm_sector_mix`'s four edge sectors (the two walks to the
    sector's end, the clear pack sector, the sector that is not a pack) at
    seeded places in every 32-sector block that has room for them, so that
    one warp of the kernel mixes scrambled, clear and non-pack sectors."""
    plain, enc = cppm_sector_mix(sectors, media_key, id_album_media, seed)
    m = plain.shape[0]
    rng = np.random.default_rng(seed)
    order = rng.integers(0, m - 4, n)
    for b in range(0, n, 32):
        w = min(32, n - b)
        if w >= 4:
            order[b + rng.choice(w, 4, replace=False)] = np.arange(m - 4, m)
    return plain[order], enc[order]


#: K8 edge chunk counts: none, one, a tile (256 chunks,
#: csrc/pcm_unpack.cuh DVDA_PCM_TILE) less one, a tile, a tile and one,
#: three tiles and 7 (a ragged last tile whose output, at most
#: configurations, ends inside a 16-byte vector)
PCM_EDGES = (0, 1, 255, 256, 257, 3 * 256 + 7)

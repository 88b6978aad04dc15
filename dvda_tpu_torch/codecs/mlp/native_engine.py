"""MLP decode on the card: native parse → chunk arenas → K1a → K234 → drain.

Port of the uniform device path of dvda_tpu/codecs/mlp/native_engine.py,
in its two modes.  The C++ host library (``dvda_tpu_torch.host``) parses
the assembled stream in frame batches and packs each chunk of restart
chains into three typed arenas (``mp_pack``); the arenas are uploaded from
pinned host memory and the chunk program runs hand-written kernels on the
device:

    per chunk:  arenas (int32/int16/int8) ─h2d→
        [device Huffman: K10, K5's lane inputs (ops/chunk_lanes.py)
          → K5 residual decode (ops/huffman_decode.py)]
        → K1a AR filter reading the arenas (ops/chunk_filter.py; the
          substreams of one geometry fused) → time-leading join
        → K234 noise + bypass + rematrix + output stage + byte pack
          (ops/rematrix.py) ─d2h→ rows of one pinned output buffer

A 24-bit stream is read back narrow by default (``DecodeConfig.
narrow_d2h``, dvda_tpu's default): the chunk's output stage is K234n,
which packs the samples at the track's tier (12-bit channel pairs, or
int16) and appends a flag that says whether they fit.  The drain
(:class:`_Drain`) settles the tier from the first flag, runs any chunk
that overflowed its tier again wider, and widens the narrow rows to
24-bit on the host at the end.

Each chunk's arenas come from ``mp_pack``, or with ``DecodeConfig(
native_pack=False)`` (and for a parse without a native handle) from the
numpy builder (:func:`_numpy_arenas`), its differential oracle: the same
bytes.  With ``DecodeConfig.multi_device`` the chunks go round-robin over
the visible CUDA devices (:func:`_decode_devices`), each drained on its
own card's side stream; with ``drain_thread`` off the outputs stay on the
card until :meth:`_Drain.finish` copies them back.

In standard mode the parse decodes the residual values on the host and
the arenas carry them.  In device-Huffman mode (``DecodeConfig.
device_huffman``) the parse walks the residual bits length-only
(skip-values mode), the arenas carry per-block decode tables and start
bits, and K5 re-decodes the values from the track's stream words, which
are uploaded once per decode (:func:`_shared_words`).

The stream is decoded as a run of uniform *sections* (constant frame
length, block size and chain length; geometry may change at a fresh
restart).  A stream the pipelined driver abandons, as dvda_tpu's does
(more than 8 sections, no progress at a frame, substreams whose geometry
disagrees, no frames), is parsed to its end (in value mode) and decoded
whole by :func:`_decode_parsed`: the arena chunk program over the whole
stream when it is uniform (:func:`_try_uniform`), else the general path
(ops/general_gather.py: K6a, K1, K6b).  When the parser bails,
:func:`decode_native` logs the reason and returns None, and the caller
(codecs/mlp/track.py) decodes the track with the Python engines
(codecs/mlp/engine.py), as dvda_tpu does.
"""

from __future__ import annotations

import collections
import sys

import numpy as np
import torch

from ... import host
from ...config import DecodeConfig, default_config
from ...ops.chunk_filter import chunk_filter
from ...ops.chunk_lanes import chunk_lanes, chunk_layout
from ...ops.general_gather import (general_pipeline, restart_chains,
                                  substream_tables)
from ...ops.lfsr import _jump_columns
from ...ops.huffman_decode import decode_residuals_device
from ...ops.rematrix import output_stage
from ...utils.log import logger
from ...utils.profiling import global_timer
from ..params import WAVE_CHANNEL, StreamParameters

__all__ = ["decode_native", "decode_host_complete", "uniform_arena_pipeline",
           "arenas_to_device", "general_tables"]

#: sentinel: the pipelined driver met a structure it does not handle —
#: decode the finished parse whole instead (dvda_tpu's ``_ABANDON``)
_ABANDON = object()


def _frame_cut(frame_end: np.ndarray, boundaries: np.ndarray, probe_end: int) -> int:
    """Number of frames to keep under the zero-frame-packet rule
    (dvd-audio.c:766-775): frames are kept up to the first post-probe
    packet interval containing no frame end."""
    if boundaries.size == 0:
        return frame_end.shape[0]
    marks = np.concatenate([[probe_end], boundaries])
    idx = np.searchsorted(frame_end, marks, side="right")
    per_packet = np.diff(idx)
    zero = np.nonzero(per_packet == 0)[0]
    if zero.size == 0:
        return frame_end.shape[0]
    return int(idx[zero[0]])


def _pack_bits(bits_per_sample: int) -> int:
    """Device byte-packing width: 24- and 16-bit streams pack to their WAV
    sample width on device; other widths (20-bit) return 0 = int32."""
    return bits_per_sample if bits_per_sample in (16, 24) else 0


def _wave_perm(parse, out_ch: int) -> np.ndarray:
    mapping = WAVE_CHANNEL[parse.assignment]
    perm = np.zeros(out_ch, dtype=np.int32)
    for c in range(out_ch):
        perm[mapping[c]] = c
    return perm


def _max_matrix_slots(mat_active: np.ndarray) -> int:
    """Highest active rematrix slot + 1 over a frame range [F, 6].  The
    driver folds each chunk's value into a running max (``mat_mm``), as the
    JAX package does, so the arenas' spec matches its spec."""
    nz = np.nonzero(np.asarray(mat_active, bool).any(axis=0))[0]
    return int(nz[-1]) + 1 if nz.size else 0


# ----------------------------------------------------------------- arenas

#: mp_pack source-array ids (host/src/mlp_parse.cc pack_src)
_PACK_SRC = {
    "rc_fir": 0, "rc_iir": 1, "iir_init": 2, "shift": 3, "quant": 4,
    "iir_reset": 5, "codebook": 6, "lsb_bits": 7, "res_offset": 8,
    "nbyp": 9,
    "mat_coeff": 20, "mat_noise": 21, "mat_out": 22, "mat_active": 23,
    "mat_quant": 24, "out_shift": 25, "frame_seed": 26, "frame_nshift": 27,
}

_W_IDX = {4: 0, 2: 1, 1: 2}
_W_BASE = {4: np.int32, 2: np.int16, 1: np.int8}
_W_TORCH = {4: torch.int32, 2: torch.int16, 1: torch.int8}


class _NativeArenaBuilder:
    """Chunk arena assembly in the native host runtime.

    Python computes the static spec and a small instruction table; every
    large copy/cast runs in one ``mp_pack`` call writing straight into the
    preallocated arena buffers.  Host-computed entries (permutation, LFSR
    jumps) are written after it.  The arenas and spec are byte-identical to
    the JAX package's arenas in both modes (tests/test_torch_chunk.py)."""

    def __init__(self, parse):
        self._parse = parse
        self._sizes = {4: 0, 2: 0, 1: 0}
        self._spec = []
        self._inst = []
        self._host = []

    def _alloc(self, name, shape, dtype):
        dt = np.dtype(dtype)
        width = dt.itemsize
        off = self._sizes[width]
        n = int(np.prod(shape)) if shape else 1
        self._sizes[width] = off + n
        self._spec.append((name, width, off, tuple(shape), str(dt)))
        return width, off

    def add_host(self, name, arr):
        width, off = self._alloc(name, arr.shape, arr.dtype)
        self._host.append((width, off, np.ascontiguousarray(arr)))

    def mark(self, name, value=0):
        """A static marker (no data; ``value`` rides in the offset slot)."""
        self._spec.append((name, 0, int(value), (), "flag"))

    def _emit(self, op, src, sub, a, bb, c, d, e=0, f=0, g=0,
              *, name, shape, dtype):
        width, off = self._alloc(name, shape, dtype)
        self._inst.append([op, src, sub, a, bb, c, d, e, f, g, width, off])

    def add_chain(self, name, src, sub, blk0, blk1, NB0, CHUNK,
                  inner_shape, dtype):
        inner = int(np.prod(inner_shape)) if inner_shape else 1
        self._emit(0, _PACK_SRC[src], sub, blk0, blk1, NB0, inner, CHUNK,
                   name=name, shape=(CHUNK, NB0) + tuple(inner_shape),
                   dtype=dtype)

    def add_head(self, name, src, sub, blk0, blk1, NB0, CHUNK,
                 inner_shape, dtype):
        inner = int(np.prod(inner_shape)) if inner_shape else 1
        self._emit(1, _PACK_SRC[src], sub, blk0, blk1, NB0, inner, CHUNK,
                   name=name, shape=(CHUNK,) + tuple(inner_shape),
                   dtype=dtype)

    def add_frame(self, name, src, f0, f1, F_pad, inner_shape, dtype):
        inner = int(np.prod(inner_shape)) if inner_shape else 1
        self._emit(2, _PACK_SRC[src], 0, f0, f1, F_pad, inner,
                   name=name, shape=(F_pad,) + tuple(inner_shape),
                   dtype=dtype)

    def add_res(self, name, sub, t0, t1, CHUNK, NB0, n_ch, S0, dtype):
        self._emit(3, 0, sub, t0 * n_ch, t1 * n_ch, 0, 0,
                   name=name, shape=(CHUNK, NB0, n_ch, S0), dtype=dtype)

    def add_byp(self, name, t0, t1, T_pad):
        self._emit(4, 0, 0, t0, t1, T_pad, 0,
                   name=name, shape=(T_pad,), dtype=np.int8)

    def add_bitpos(self, name, sub, blk0, blk1, NB0, nsub, CHUNK, base_bit,
                   suboff):
        """Per-(block, sub-lane) start bits relative to ``base_bit``; with
        ``suboff >= 0`` the parse's flat sub-lane offsets from there on are
        added (``sub_every`` split), else one start per block."""
        self._emit(5, 0, sub, blk0, blk1, NB0, nsub, CHUNK, base_bit, suboff,
                   name=name, shape=(CHUNK, NB0, nsub), dtype=np.int32)

    def finish(self, pin: bool = False, full: bool = False):
        """(a4, a2, a1), spec.  With ``pin`` the arenas are page-locked
        torch tensors (for non-blocking uploads), else numpy arrays.

        ``mp_pack`` writes each entry's valid rows and leaves the padding
        rows of a partial chunk to the zeroed buffer.  A ``full`` chunk has
        no padding rows, so its arenas skip the zero fill (on pinned
        memory the fill cost ~2.5 ms per 5.1/96k chunk on the H100 host,
        about a fifth of the decode)."""
        if pin:
            alloc = torch.empty if full else torch.zeros
            tens = tuple(alloc(self._sizes[w], dtype=_W_TORCH[w],
                               pin_memory=True) for w in (4, 2, 1))
            arenas = tuple(t.numpy() for t in tens)
        else:
            alloc = np.empty if full else np.zeros
            arenas = tuple(alloc(self._sizes[w], _W_BASE[w])
                           for w in (4, 2, 1))
        if self._inst:
            inst = np.asarray(self._inst, dtype=np.int64).reshape(-1, 12)
            self._parse.pack(inst, *arenas)
        for width, off, arr in self._host:
            arenas[_W_IDX[width]][off : off + arr.size] = \
                arr.view(_W_BASE[width]).ravel()
        return (tens if pin else arenas), tuple(self._spec)


class _ArenaBuilder:
    """Packs named arrays into three typed arenas + a static spec: the
    numpy arena builder (dvda_tpu's ``_ArenaBuilder``, native_engine.py:
    375-402), behind ``DecodeConfig(native_pack=False)`` and for parses
    without a live native handle.  Its arenas and spec are byte-identical
    to :class:`_NativeArenaBuilder`'s (tests/test_torch_pack.py)."""

    def __init__(self):
        self._parts = {4: [], 2: [], 1: []}
        self._spec = []

    def add(self, name: str, arr: np.ndarray) -> None:
        width = arr.dtype.itemsize
        base = {4: np.int32, 2: np.int16, 1: np.int8}[width]
        off = sum(p.size for p in self._parts[width])
        self._parts[width].append(np.ascontiguousarray(arr).view(base).ravel())
        self._spec.append((name, width, off, tuple(arr.shape),
                           str(arr.dtype)))

    def mark(self, name: str, value: int = 0) -> None:
        """A static marker entry (no data; ``value`` rides in the offset
        slot) — used for per-substream kernel constants like S0/J."""
        self._spec.append((name, 0, int(value), (), "flag"))

    def finish(self, pin: bool = False):
        """(a4, a2, a1), spec: each arena its parts end to end.  With
        ``pin`` page-locked torch tensors (for non-blocking uploads), else
        numpy arrays."""
        arenas = []
        for w in (4, 2, 1):
            t = torch.empty(sum(p.size for p in self._parts[w]),
                            dtype=_W_TORCH[w], pin_memory=pin)
            a, off = t.numpy(), 0
            for part in self._parts[w]:
                a[off : off + part.size] = part
                off += part.size
            arenas.append(t if pin else a)
        return tuple(arenas), tuple(self._spec)


def _padded_residuals_range(sub, t_lo: int, t_hi: int, n_blocks: int,
                            S0: int) -> np.ndarray:
    """Residuals for a block range → [n_blocks, n_ch, S0].  The flat array
    is ragged per block, so the range is addressed by absolute *sample*
    offsets (valid across sections with different block sizes)."""
    n_ch = sub["shift"].shape[1]
    flat = sub["residuals"]
    return flat[t_lo * n_ch : t_hi * n_ch].reshape(n_blocks, n_ch, S0)


def _window_rows(span_bits: int) -> int:
    """dvda_tpu's residual-kernel window size in words (a power of two
    holding a sub-lane's widest bit span plus a 64-bit guard, at most
    8192).  K5 reads the words directly and does not use it; the arenas'
    spec carries it so that it equals dvda_tpu's."""
    need = (int(span_bits) + 64 + 31) // 32
    rows = max(8, 1 << (need - 1).bit_length())
    if rows > 8192:
        raise ValueError(f"residual sub-lane span {span_bits} bits "
                         f"exceeds the 8192-word window bound")
    return rows


class _SharedWords:
    """The track's stream as big-endian 32-bit words (int32 bits), built
    once per decode and uploaded once per device that runs a chunk
    (dvda_tpu's ``_SharedWords``, :866-894): every chunk's K5 launch reads
    them through the chunk's ``wordbase``.  Padded like dvda_tpu's to a
    multiple of 8192 words after a 16-word guard, so the 8192-word-aligned
    chunk bases and the kernel's three-word reads stay inside.  A CUDA
    upload goes from pinned memory, non-blocking, on the device's current
    stream."""

    def __init__(self, stream: bytes, pin: bool):
        with global_timer.stage("mlp/words"):
            n = -(-((len(stream) + 3) // 4 + 16) // 8192) * 8192
            self.host = torch.empty(n, dtype=torch.int32, pin_memory=pin)
            a = self.host.numpy()
            a8 = a.view(np.uint8)
            a8[: len(stream)] = np.frombuffer(stream, np.uint8)
            a8[len(stream):] = 0
            if sys.byteorder == "little":
                a.byteswap(inplace=True)
        self._on = {}

    def on(self, device: torch.device) -> torch.Tensor:
        """The words on ``device`` (uploaded at the first call)."""
        words = self._on.get(device)
        if words is None:
            words = self._on[device] = (
                self.host.to(device, non_blocking=True)
                if device.type == "cuda" else self.host)
        return words


def _shared_words(stream: bytes, device: torch.device) -> torch.Tensor:
    """The track's stream words on ``device`` (:class:`_SharedWords`)."""
    return _SharedWords(stream, device.type == "cuda").on(device)


def _chunk_word_base(subs_info, c0: int) -> int:
    """The bit every bitpos of the chunk is relative to: the chunk's first
    residual bit over all substreams, aligned down to 2^18 bits (8192
    words), so the per-chunk tables stay int32 on tracks of any length."""
    bit0 = min(int(si[0]["res_bitpos"][si[1] + c0 * si[3]])
               for si in subs_info)
    return (bit0 >> 18) << 18


def _add_huffman_tables(b, s_idx, sub, blk_base, blk0, blk1, S0, NB0,
                        suboff_base, CHUNK, base_bit, last):
    """Substream ``s_idx``'s device-Huffman arenas, in dvda_tpu's order
    (native_engine.py:1760-1797): start bits, decode tables, kernel
    constants and, for the last substream, the bypass slot map."""
    n_ch = sub["codebook"].shape[1]
    k = int(sub.get("sub_every", 0) or 0)
    if k:  # split: ceil(S0/k) sub-lanes per block, flat offsets carried
        nsub = -(-S0 // k)
        off0 = suboff_base + (blk0 - blk_base) * nsub
        b.mark(f"s{s_idx}_k", min(k, S0))
    else:
        nsub, off0 = 1, -1
        b.mark(f"s{s_idx}_k", S0)
    b.add_bitpos(f"s{s_idx}_bitpos", s_idx, blk0, blk1, NB0, nsub, CHUNK,
                 base_bit, off0)
    b.mark(f"s{s_idx}_NW", _window_rows(sub.get("sub_span_max", 0)))
    for name, src, inner, dtype in (("cb", "codebook", (n_ch,), np.int8),
                                    ("lsbb", "lsb_bits", (n_ch,), np.int8),
                                    ("off", "res_offset", (n_ch,), np.int32),
                                    ("nbyp", "nbyp", (), np.int8)):
        b.add_chain(f"s{s_idx}_{name}", src, s_idx, blk0, blk1, NB0, CHUNK,
                    inner, dtype)
    b.mark(f"s{s_idx}_S", S0)
    b.mark(f"s{s_idx}_J", n_ch + (1 if sub["nbyp"][blk0:blk1].any() else 0))
    if last:
        # slot m's bit is symbol kidx[m] of the burst: kidx = popcount of
        # the lower mask bits
        bits = ((sub["byp_mask"][blk0:blk1][:, None].astype(np.int32)
                 >> np.arange(6)) & 1)
        kidx = (np.cumsum(bits, axis=1) - bits).astype(np.int8)
        for name, x in (("bypk", kidx), ("bypv", bits.astype(np.int8))):
            full = np.zeros((CHUNK, NB0, 6), np.int8)
            full[: x.shape[0] // NB0] = x.reshape(-1, NB0, 6)
            b.add_host(f"s{s_idx}_{name}", full)


def _narrow_tier0(pack_bits: int, out_ch: int, cfg) -> int:
    """The narrow readback's first tier for a stream (dvda_tpu's
    ``_narrow_tier0``, :907-916): 24-bit streams start at the 12-bit tier
    when the channel count is even, else at int16; 0 = narrow off."""
    if pack_bits != 24 or not cfg.resolved_narrow_d2h():
        return 0
    return 12 if out_ch % 2 == 0 else 16


def _build_chunk_arenas(parse, subs_info, c0, c1, CHUNK, period, L0,
                        out_ch, pack_bits, f_base, t_base, mat_mm,
                        pin=False, huffman=False, narrow=0, native=True):
    """Arenas + spec for section-relative chains [c0, c1) — dvda_tpu's
    ``_dispatch_uniform_chunk`` up to the upload (:1649-1718), in standard
    mode or, with ``huffman``, in device-Huffman mode (decode tables
    instead of residuals and bypass bits).  ``subs_info`` carries (sub,
    block_base, S0, NB0[, suboff]) per substream, ``suboff`` being the
    section's first flat ``sub_bitpos`` index (device Huffman);
    ``f_base``/``t_base`` are the section's absolute frame and sample
    offsets.  The arenas come from ``mp_pack`` (:func:`_native_arenas`)
    or, without ``native`` or a live native handle on ``parse``, from
    numpy (:func:`_numpy_arenas`): the same bytes either way.  ``narrow``
    (12 or 16) marks a 24-bit chunk for the narrow readback at that tier,
    as dvda_tpu's ``_finish_dispatch`` does (:1700-1708)."""
    build = (_native_arenas if native and getattr(parse, "_h", None)
             is not None else _numpy_arenas)
    arenas, spec = build(parse, subs_info, c0, c1, CHUNK, period, L0,
                         out_ch, f_base, t_base, mat_mm, pin, huffman)
    if pack_bits:
        spec = spec + ((f"__pack{pack_bits}__", 0, 0, (), "flag"),)
        if narrow and pack_bits == 24:
            spec = spec + (("__narrow__", 0, narrow, (), "flag"),)
    return arenas, spec


def _native_arenas(parse, subs_info, c0, c1, CHUNK, period, L0, out_ch,
                   f_base, t_base, mat_mm, pin, huffman):
    """(a4, a2, a1), spec from ``mp_pack`` — dvda_tpu's
    ``_dispatch_chunk_native`` (:1729-1846) up to its dispatch."""
    b = _NativeArenaBuilder(parse)
    fpc = period // L0
    f0 = f_base + c0 * fpc
    f1 = f_base + c1 * fpc
    t0, t1 = t_base + c0 * period, t_base + c1 * period
    if huffman:
        base_bit = _chunk_word_base(subs_info, c0)
        b.add_host("wordbase", np.asarray(base_bit >> 5, np.int32))
    for s_idx, si in enumerate(subs_info):
        sub, blk_base, S0, NB0 = si[:4]
        blk0, blk1 = blk_base + c0 * NB0, blk_base + c1 * NB0
        n_ch = sub["shift"].shape[1]
        if huffman:
            _add_huffman_tables(b, s_idx, sub, blk_base, blk0, blk1, S0, NB0,
                                si[4], CHUNK, base_bit,
                                s_idx == len(subs_info) - 1)
        else:
            amax = sub.get("res_amax")
            res_dtype = np.int16 if (amax is not None
                                     and amax <= 32767) else np.int32
            b.add_res(f"s{s_idx}_res", s_idx, t0, t1, CHUNK, NB0, n_ch, S0,
                      res_dtype)
        # real encoders set parameters at restarts only: when no non-head
        # block re-reads them, one row per chain is shipped
        per_chain = NB0 == 1 or not (
            sub["param_update"][blk0:blk1].reshape(-1, NB0)[:, 1:].any())
        add = b.add_head if per_chain else b.add_chain
        sfx = "_c" if per_chain else ""
        for name, inner, dtype in (("rc_fir", (n_ch, 8), np.int16),
                                   ("rc_iir", (n_ch, 8), np.int16),
                                   ("iir_init", (n_ch, 8), np.int32),
                                   ("shift", (n_ch,), np.int8),
                                   ("quant", (n_ch,), np.int8),
                                   ("iir_reset", (n_ch,), np.int8)):
            add(f"s{s_idx}_{name}{sfx}", name, s_idx, blk0, blk1, NB0, CHUNK,
                inner, dtype)

    T_pad = CHUNK * period
    F_pad = T_pad // L0
    b.add_frame("mat_coeff", "mat_coeff", f0, f1, F_pad, (6, 8), np.int16)
    b.add_frame("mat_noise", "mat_noise", f0, f1, F_pad, (6, 2), np.int16)
    b.add_frame("mat_out", "mat_out", f0, f1, F_pad, (6,), np.int8)
    b.add_frame("mat_active", "mat_active", f0, f1, F_pad, (6,), np.int8)
    b.mark("mat_mm", mat_mm)
    b.add_frame("mat_quant", "mat_quant", f0, f1, F_pad, (6,), np.int8)
    b.add_frame("out_shift", "out_shift", f0, f1, F_pad, (8,), np.int8)
    b.add_host("wave_perm", _wave_perm(parse, out_ch).astype(np.int8))
    b.add_frame("frame_seed", "frame_seed", f0, f1, F_pad, (), np.uint32)
    b.add_frame("frame_nshift", "frame_nshift", f0, f1, F_pad, (), np.int8)
    if not huffman:
        b.add_byp("byp", t0, t1, T_pad)
    b.add_host("jumps", _jumps(L0))
    return b.finish(pin=pin, full=c1 - c0 == CHUNK)


def _jumps(L0: int) -> np.ndarray:
    """GF(2) jump columns: part of the arena layout the JAX chunk program
    expands noise with; K234 steps the LFSR serially and does not read
    them."""
    K = max(1, int(np.ceil(np.log2(max(L0, 2)))))
    return np.array([_jump_columns(k) for k in range(K)], dtype=np.uint32)


def _numpy_arenas(parse, subs_info, c0, c1, CHUNK, period, L0, out_ch,
                  f_base, t_base, mat_mm, pin, huffman):
    """(a4, a2, a1), spec assembled in numpy — dvda_tpu's
    ``_dispatch_chunk_py`` (:1849-2003) up to its dispatch, the
    differential oracle of :func:`_native_arenas`.  It reads the parse's
    arrays only, so it also serves a parse without a native handle."""
    b = _ArenaBuilder()
    fpc = period // L0
    f0 = f_base + c0 * fpc
    f1 = f_base + c1 * fpc
    t0, t1 = t_base + c0 * period, t_base + c1 * period
    base_bit = 0
    if huffman:
        base_bit = _chunk_word_base(subs_info, c0)
        b.add("wordbase", np.asarray(base_bit >> 5, np.int32))
    for s_idx, si in enumerate(subs_info):
        sub, blk_base, S0, NB0 = si[:4]
        suboff_base = si[4] if len(si) > 4 else None
        blk0, blk1 = blk_base + c0 * NB0, blk_base + c1 * NB0

        def chainview(x, dtype=None, NB0=NB0):
            """Pre-sliced block-range array [(blk1-blk0), …] → chain view
            [CHUNK, NB0, …] (zero-padded trailing chains)."""
            dtype = dtype or x.dtype
            out = np.zeros((CHUNK, NB0) + x.shape[1:], dtype=dtype)
            out[: x.shape[0] // NB0] = x.reshape((-1, NB0) + x.shape[1:])
            return out

        if huffman:
            n_ch = sub["codebook"].shape[1]
            bp = (sub["res_bitpos"][blk0:blk1] - base_bit).astype(np.int32)
            k = int(sub.get("sub_every", 0) or 0)
            if k:
                # sub-lane split: per-block every-k-sample offsets widen
                # bitpos to [nblk, nsub]; preceding blocks each hold
                # ceil(len/k) flat entries
                nsub = -(-S0 // k)
                if suboff_base is not None:  # O(1): section counter
                    off0 = suboff_base + (blk0 - blk_base) * nsub
                else:
                    off0 = int((-(-sub["len"][:blk0].astype(np.int64)
                                  // k)).sum())
                rel = sub["sub_bitpos"][off0 : off0 + (blk1 - blk0) * nsub]
                bp = bp[:, None] + rel.reshape(blk1 - blk0, nsub)
                b.mark(f"s{s_idx}_k", min(k, S0))
            else:
                bp = bp[:, None]
                b.mark(f"s{s_idx}_k", S0)
            b.add(f"s{s_idx}_bitpos", chainview(bp))
            b.mark(f"s{s_idx}_NW",
                   _window_rows(sub.get("sub_span_max", 0)))
            b.add(f"s{s_idx}_cb",
                  chainview(sub["codebook"][blk0:blk1], np.int8))
            b.add(f"s{s_idx}_lsbb",
                  chainview(sub["lsb_bits"][blk0:blk1], np.int8))
            b.add(f"s{s_idx}_off", chainview(sub["res_offset"][blk0:blk1]))
            nbyp = sub["nbyp"][blk0:blk1]
            b.add(f"s{s_idx}_nbyp", chainview(nbyp.view(np.int8)))
            b.mark(f"s{s_idx}_S", S0)
            b.mark(f"s{s_idx}_J", n_ch + (1 if nbyp.any() else 0))
            if s_idx == len(subs_info) - 1:
                # bypassed-LSB slot map for the final substream: slot m's
                # bit is the k-th bypass symbol, k = popcount of lower mask
                bits = ((sub["byp_mask"][blk0:blk1][:, None].astype(np.int32)
                         >> np.arange(6)) & 1)
                kidx = (np.cumsum(bits, axis=1) - bits).astype(np.int8)
                b.add(f"s{s_idx}_bypk", chainview(kidx))
                b.add(f"s{s_idx}_bypv", chainview(bits.astype(np.int8)))
        else:
            res = _padded_residuals_range(sub, t0, t1, blk1 - blk0, S0)
            # the parser tracks max |residual|; without it, scan
            amax = sub.get("res_amax")
            res_dtype = np.int16 if (
                amax <= 32767 if amax is not None
                else (np.abs(res) < 32768).all()) else np.int32
            res_c = np.zeros((CHUNK, NB0) + res.shape[1:], dtype=res_dtype)
            res_c[: (blk1 - blk0) // NB0] = res.reshape(
                (-1, NB0) + res.shape[1:])
            b.add(f"s{s_idx}_res", res_c)

        # one row per chain when no non-head block re-reads parameters
        per_chain = NB0 == 1 or not (
            sub["param_update"][blk0:blk1].reshape(-1, NB0)[:, 1:].any())
        if per_chain:
            def headview(x, dtype=None):
                """Chain-head rows [nc, …] → [CHUNK, …] (zero-padded)."""
                heads = x[blk0:blk1:NB0]
                out = np.zeros((CHUNK,) + heads.shape[1:],
                               dtype=dtype or x.dtype)
                out[: heads.shape[0]] = heads
                return out

            b.add(f"s{s_idx}_rc_fir_c", headview(sub["rc_fir"], np.int16))
            b.add(f"s{s_idx}_rc_iir_c", headview(sub["rc_iir"], np.int16))
            b.add(f"s{s_idx}_iir_init_c", headview(sub["iir_init"]))
            b.add(f"s{s_idx}_shift_c", headview(sub["shift"], np.int8))
            b.add(f"s{s_idx}_quant_c", headview(sub["quant"], np.int8))
            b.add(f"s{s_idx}_iir_reset_c",
                  headview(sub["iir_reset"]).view(np.int8))
        else:
            for name, dtype in (("rc_fir", np.int16), ("rc_iir", np.int16),
                                ("iir_init", None), ("shift", np.int8),
                                ("quant", np.int8), ("iir_reset", np.int8)):
                b.add(f"s{s_idx}_{name}",
                      chainview(sub[name][blk0:blk1], dtype))

    T_pad = CHUNK * period
    F_pad = T_pad // L0

    def padF(x, dtype=None):
        seg = x[f0:f1]
        pad = [(0, F_pad - seg.shape[0])] + [(0, 0)] * (x.ndim - 1)
        out = np.pad(seg, pad)
        return out.astype(dtype) if dtype is not None else out

    b.add("mat_coeff", padF(parse.mat_coeff, np.int16))
    b.add("mat_noise", padF(parse.mat_noise, np.int16))
    b.add("mat_out", padF(parse.mat_out, np.int8))
    b.add("mat_active", padF(parse.mat_active, np.int8))
    b.mark("mat_mm", mat_mm)
    b.add("mat_quant", padF(parse.mat_quant, np.int8))
    b.add("out_shift", padF(parse.out_shift, np.int8))
    b.add("wave_perm", _wave_perm(parse, out_ch).astype(np.int8))
    b.add("frame_seed", padF(parse.frame_seed))
    b.add("frame_nshift", padF(parse.frame_nshift, np.int8))
    if not huffman:  # device-Huffman mode decodes these on the device
        byp = np.zeros(T_pad, dtype=np.int8)
        byp[: t1 - t0] = parse.bypassed_packed[t0:t1].view(np.int8)
        b.add("byp", byp)
    b.add("jumps", _jumps(L0))
    return b.finish(pin=pin)


def arenas_to_device(a4, a2, a1, spec, device):
    """The three chunk arenas (numpy arrays, e.g. exactly what the JAX
    package's ``mp_pack`` + ``_NativeArenaBuilder.finish`` produce, or the
    port's pinned tensors) as tensors on ``device``.  CUDA uploads go from
    page-locked memory with ``non_blocking=True`` on the current stream."""
    device = torch.device(device)
    arenas = []
    for a, w in ((a4, 4), (a2, 2), (a1, 1)):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if t.dtype != _W_TORCH[w] or t.dim() != 1:
            raise TypeError(f"arena {w}: expected 1-D {_W_TORCH[w]}, got "
                            f"{t.dim()}-D {t.dtype}")
        if device.type == "cuda":
            if not t.is_pinned():
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        arenas.append(t)
    for name, width, off, shape, dtype in spec:
        if dtype == "flag":
            continue
        n = int(np.prod(shape)) if shape else 1
        if off + n > arenas[_W_IDX[width]].shape[0]:
            raise ValueError(f"spec entry {name!r} overruns its arena")
    return tuple(arenas)


def unpack_spec(a4, a2, a1, spec):
    """(arrays, flags): the spec's entries as views of the three arenas,
    and its static markers (the value rides in the offset slot)."""
    arenas = {4: a4, 2: a2, 1: a1}
    arrs, flags = {}, {}
    for name, width, off, shape, dtype in spec:
        if dtype == "flag":
            flags[name] = off
            continue
        n = int(np.prod(shape)) if shape else 1
        arrs[name] = arenas[width].narrow(0, off, n).view(shape)
    return arrs, flags


def huffman_inputs(lanes, arrs, flags, i, words):
    """(args, kwargs) of :func:`decode_residuals_device` for substream ``i``
    of a device-Huffman chunk, as dvda_tpu's chunk program passes them
    (native_engine.py:146-169): K10's int32 lane inputs
    (``lanes.huffman[i]``, chain-major rows), time-leading output, and for
    the last substream the bypass slot map.  The chunk program adds
    ``out``/``lane0``: its place in the fused filter input."""
    bitpos, cb, lsbb, off, quant, nbyp = lanes.huffman[i]
    Lc, n_ch = cb.shape
    S0 = flags[f"s{i}_S"]
    args = (words, bitpos, cb, lsbb, off, quant, nbyp, S0, flags[f"s{i}_J"],
            flags.get(f"s{i}_k", S0), flags.get(f"s{i}_NW", 32),
            arrs[f"s{i}_cb"].shape[1])
    kw = dict(word_base=arrs.get("wordbase"))
    if f"s{i}_bypk" in arrs:
        kw.update(bypk=arrs[f"s{i}_bypk"].view(Lc, 6),
                  bypv=arrs[f"s{i}_bypv"].view(Lc, 6))
    return args, kw


def uniform_arena_pipeline(a4, a2, a1, spec, words=None):
    """The chunk program (dvda_tpu's ``_uniform_arena_pipeline``,
    native_engine.py:82-372) on the arenas' device.  ``words`` is the
    track's stream (:func:`_shared_words`), which device-Huffman arenas
    need.  Returns uint8 ``[T_pad, C_out*nbytes]`` WAV-ordered bytes for
    ``__pack24__``/``__pack16__`` specs, else int32 ``[T_pad, C_out]``;
    with ``__pack24__`` and ``__narrow__`` the narrow rows at its tier and
    8 flag rows (K234n: uint8 ``[T_pad + 8, C_out*2]`` at tier 16,
    ``[T_pad + 8, C_out/2*3]`` at tier 12)."""
    return _chunk_program(a4, a2, a1, spec, words)[0]


def _chunk_program(a4, a2, a1, spec, words=None):
    """(output, tier, redo) of :func:`uniform_arena_pipeline`: the tier its
    output stage ran at (0: wide) and ``redo(tier)``, which runs the output
    stage again on the chunk's filter output at another tier (0: wide).
    dvda_tpu's ``redo`` reruns the whole chunk program from the arenas;
    here the filter (and K5) run once a chunk, and a redo is one K234
    launch.

    On the card a chunk launches the port's kernels only: in standard
    mode K1a once per filter launch (:func:`chunk_filter`, the filter
    reading its inputs from the arenas), then K234 or K234n; in
    device-Huffman mode first K10 (K5's lane inputs and the residual
    buffers, :func:`chunk_lanes`) and K5 per substream, each writing its
    lanes of the launch's residual buffer, then K1a on those buffers.
    Where the substreams' geometries differ, each K1a launch writes its
    lanes at their columns of the one series K234 reads."""
    arrs, flags = unpack_spec(a4, a2, a1, spec)
    if "__pallas__" in flags:
        raise NotImplementedError(
            "chunk spec carries __pallas__: the Pallas route is not ported "
            "(ROADMAP item 12)")
    huffman = any(name.endswith("_bitpos") for name in arrs)
    if huffman and words is None:
        raise ValueError("device-Huffman arenas need the track's stream "
                         "words")
    byp, residuals = arrs.get("byp"), None
    if huffman:
        lanes = chunk_lanes(a4, a2, a1, spec)
        residuals = lanes.residuals
        for i, (g, lane0) in enumerate(lanes.places):
            args, kw = huffman_inputs(lanes, arrs, flags, i, words)
            _, slots = decode_residuals_device(
                *args, **kw, out=residuals[g], lane0=lane0)
            if "bypk" in kw:
                byp = slots
    # substreams of one (NB0, S0) run ONE filter launch on the fused lanes;
    # substreams of different geometry (one launch each) write their
    # channel-major lanes at their columns of the series, in the global
    # order c*Bc + b (dvda_tpu's concatenation on the lane axis)
    series = chunk_filter(a4, a2, a1, spec, residuals)
    nbytes = 3 if "__pack24__" in flags else 2 if "__pack16__" in flags else 0
    tier = (flags["__narrow__"] or 16) if (nbytes == 3
                                           and "__narrow__" in flags) else 0
    stage = (series, arrs["frame_seed"], arrs["frame_nshift"], byp,
             arrs["mat_coeff"], arrs["mat_noise"], arrs["mat_out"],
             arrs["mat_active"], arrs["mat_quant"], arrs["out_shift"],
             arrs["wave_perm"])
    kw = dict(chains=chunk_layout(spec).subs[0][0],
              n_mats=flags.get("mat_mm", 6), nbytes=nbytes)

    def redo(retier=0):
        return output_stage(*stage, **kw, tier=retier)

    return redo(tier), tier, redo


# ------------------------------------------------------------------ drain

class _Drain:
    """Chunk outputs → one pinned host buffer, and the narrow tiers.

    Each pushed chunk's valid rows are copied device-to-host with
    ``non_blocking=True`` on a side CUDA stream of the chunk's device,
    which waits on an event recorded on that device's compute stream after
    the chunk's kernels; parse and dispatch of later chunks run on while
    the copies drain.  Chunks round-robin over several cards
    (``DecodeConfig.multi_device``) drain each on its own card's side
    stream into the one buffer (page-locked memory is reachable from every
    device); every side stream is synchronised wherever one is waited for.
    On the CPU the copies are plain synchronous copies.  The buffer holds
    bytes, sized from an estimate of the track's samples, and grows when
    pushes outrun it (wait for the copies in flight, then move the filled
    bytes).

    Narrow tiers (dvda_tpu's ``_Drainer`` and ``_finish_uniform``): a
    chunk pushed at tier 12 or 16 brings its ``redo``; its flag byte is
    copied beside its rows, and an event recorded after both.  Flags are
    read in push order as their events complete (:meth:`poll`, after each
    push, never waiting).  The first flag read settles the track's
    :attr:`tier`: kept if the chunk fits, 16 if a 12-bit chunk fits int16
    (flag bit 1), else 0 (wide).  A chunk whose own flag says it overflowed
    its tier is run again (``redo``) at 16 where bit 1 is set, else wide,
    and pushed again in its place.  :meth:`throttle` waits for the first
    flag once 3 narrow chunks were pushed before the tier settled.
    :meth:`finish` reads every flag left, runs those redos, and widens the
    narrow rows into 24-bit rows with the host library.

    Without the side stream (``side=False``: ``DecodeConfig(drain_thread=
    False)``, dvda_tpu's drain without its thread) the chunk outputs stay
    on the card.  Only the flags pushed before the tier settles are copied
    at once, on the compute stream, and read as they land (dvda_tpu's
    ``_narrow_poll``); :meth:`finish` queues every chunk's copy in push
    order (dvda_tpu's ``_finish_uniform``), then reads the flags left and
    runs their redos.  The bytes are those of the default mode."""

    def __init__(self, device: torch.device, row_bytes: int, dtype,
                 capacity: int, tier: int = 0, side: bool = True):
        self._cuda = device.type == "cuda"
        self._side = side
        self._row, self._dtype = row_bytes, dtype
        self._used = 0
        self._buf = self._alloc(max(1, int(capacity)) * row_bytes)
        self._streams = {}  # device → the stream its copies are queued on
        self._tail = None   # the stream of the last copy
        self._chunks = []   # per chunk: [rows, tier, byte offset, bytes]
        self._open = collections.deque()  # narrow chunks' flags in flight
        # without the side stream: per chunk (output, rows, byte offset,
        # flag offset or None) left on the card, in push order, and the
        # flags to read after their copies
        self._held = {}
        self._late = []
        self._unsettled = 0  # narrow chunks pushed before the tier settled
        #: the track's tier: 12, 16, or 0 (wide)
        self.tier = tier
        self.settled = not tier
        #: chunks run again at a wider tier, and bytes copied to the host
        self.redone = 0
        self.drained = 0

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self._cuda)

    def _sync(self) -> None:
        """Wait for every copy queued (each device's copy stream)."""
        for stream in self._streams.values():
            stream.synchronize()

    def _reserve(self, nbytes: int) -> int:
        """The byte offset of ``nbytes`` new bytes at the end."""
        need = self._used + nbytes
        if need > self._buf.shape[0]:
            if self._cuda:
                self._sync()  # copies in flight: the old buffer
            new = self._alloc(max(need, 2 * self._buf.shape[0]))
            new[: self._used].copy_(self._buf[: self._used])
            self._buf = new
        off, self._used = self._used, need
        return off

    def _copy(self, out: torch.Tensor, n: int, at: int,
              flag_at: int | None = None) -> None:
        """Queue the copy of ``out[:n]`` to the bytes from ``at`` and, with
        ``flag_at``, of the flag (the last byte of ``out``) to that byte:
        on CUDA on the side stream of ``out``'s device, after its compute
        stream's work (without the side stream, on the compute stream)."""
        nb = n * out.shape[1] * out.element_size()
        src = out[:n].reshape(-1).view(torch.uint8)
        dst = self._buf[at : at + nb]
        flag = None if flag_at is None else self._buf[flag_at : flag_at + 1]
        self.drained += nb + (flag is not None)
        if not self._cuda:
            dst.copy_(src)
            if flag is not None:
                flag.copy_(out[-1, -1:])
            return
        dev = out.device
        with torch.cuda.device(dev):
            compute = torch.cuda.current_stream(dev)
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = (torch.cuda.Stream(dev)
                                               if self._side else compute)
            if stream != compute:
                ready = torch.cuda.Event()
                ready.record(compute)
                stream.wait_event(ready)
            with torch.cuda.stream(stream):
                if nb:
                    dst.copy_(src, non_blocking=True)
                if flag is not None:
                    flag.copy_(out[-1, -1:], non_blocking=True)
            if stream != compute:
                out.record_stream(stream)
        self._tail = stream

    def push(self, dev_out: torch.Tensor, n: int, tier: int = 0,
             redo=None, _idx: int | None = None) -> None:
        """Queue the copy of ``dev_out[:n]``: rows of the output, or at
        ``tier`` 12 or 16 K234n's narrow rows, whose flag sits in the last
        row; ``redo(tier)`` gives the chunk's output at another tier."""
        if _idx is None:
            _idx = len(self._chunks)
            self._chunks.append(None)
        nb = n * dev_out.shape[1] * dev_out.element_size()
        off = self._reserve(nb + (1 if tier else 0))
        flag_at = off + nb if tier else None
        self._chunks[_idx] = [n, tier, off, nb]
        early = tier and not self.settled
        if early:
            self._unsettled += 1
        if self._side:
            self._copy(dev_out, n, off, flag_at)
        else:
            self._held[_idx] = (dev_out, n, off, None if early else flag_at)
            if early:
                self._copy(dev_out, 0, off, flag_at)
            elif tier:
                self._late.append((_idx, tier, flag_at, redo))
        if tier and (self._side or early):
            self._open.append((_idx, tier, flag_at, self._landed(), redo))
        self.poll()

    def _landed(self):
        """An event that completes when the copies queued so far on the
        last copy's stream have landed (None on the CPU, where they
        have)."""
        if not self._cuda:
            return None
        done = torch.cuda.Event()
        done.record(self._tail)
        return done

    def poll(self, block: bool = False) -> None:
        """Read the flags whose copies have landed, in push order; with
        ``block``, wait for the first."""
        while self._open:
            idx, tier, at, done, redo = self._open[0]
            if done is not None and not done.query():
                if not block:
                    return
                done.synchronize()
            block = False
            self._open.popleft()
            self._resolve(idx, tier, int(self._buf[at]), redo)

    def _resolve(self, idx: int, tier: int, flag: int, redo) -> None:
        """Act on chunk ``idx``'s flag (see the class docstring)."""
        retier = 16 if tier == 12 and flag & 2 else 0
        if not self.settled:
            self.settled = True
            if not flag & 1:
                self.tier = retier
        if flag & 1:
            return
        self.redone += 1
        self.push(redo(retier), self._chunks[idx][0], retier,
                  redo if retier else None, _idx=idx)

    def throttle(self) -> None:
        """Wait for the first flag once 3 narrow chunks were pushed before
        the tier settled: bounds the chunks run at a wrong tier."""
        if not self.settled and self._unsettled >= 3:
            self.poll(block=True)

    def discard(self) -> None:
        """Drop what was pushed: wait for the copies in flight."""
        self._open.clear()
        self._held.clear()
        self._late.clear()
        if self._cuda:
            self._sync()

    def finish(self, T: int) -> np.ndarray:
        """The first ``T`` rows as a numpy array (rows never pushed are
        zero): every flag read and its redo run first (without the side
        stream: every copy queued, in push order, then the flags left
        read), then one synchronisation with the copy streams; narrow rows
        widened."""
        while self._open:
            self.poll(block=True)
        while self._held:
            held, self._held = self._held, {}
            for out, n, at, flag_at in held.values():
                self._copy(out, n, at, flag_at)
            if self._cuda:
                self._sync()
            late, self._late = self._late, []
            for idx, tier, at, redo in late:
                self._resolve(idx, tier, int(self._buf[at]), redo)
        if self._cuda:
            self._sync()
        want = T * self._row
        ends = np.cumsum([0] + [c[3] for c in self._chunks])
        if all(c[1] == 0 and c[2] == e for c, e in zip(self._chunks, ends)):
            # the rows lie in order from byte 0: hand out the buffer itself
            if want > self._buf.shape[0]:
                self._reserve(want - self._used)
            if self._used < want:
                self._buf[self._used : want].zero_()
            return self._buf[:want].view(self._dtype).view(T, -1).numpy()
        with global_timer.stage("mlp/widen"):
            out = np.zeros(want, np.uint8)
            src = self._buf.numpy()
            row = 0
            for n, tier, off, nb in self._chunks:
                take = min(n, T - row)
                if take <= 0:
                    break
                dst = out[row * self._row : (row + take) * self._row]
                part = src[off : off + take * (nb // n)]
                if not tier:
                    dst[:] = part
                elif not (host.widen24 if tier == 16 else host.widen12)(
                        part, dst):
                    raise RuntimeError("the host library's widen is "
                                       "unavailable")
                row += take
        return out.reshape(T, -1)  # only 24-bit bytes are read back narrow


def _unpack_raw(raw, T, out_ch, pack_bits, want_packed):
    if not pack_bits or want_packed:
        return raw  # int32 samples, or uint8 [T, C_out*nbytes] WAV payload
    with global_timer.stage("mlp/unpack"):
        b = raw.reshape(T, out_ch, pack_bits // 8).astype(np.int32)
        if pack_bits == 16:
            v = b[..., 0] | (b[..., 1] << 8)
            return ((v ^ 0x8000) - 0x8000).astype(np.int32)
        v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        return ((v ^ 0x800000) - 0x800000).astype(np.int32)


# ------------------------------------------------------------ the driver

def _discover_geometry(st, parse_step, f0, blk0s):
    """Geometry of the section starting at frame ``f0`` / blocks ``blk0s``:
    frame length, per-substream block size and chain length (distance to
    the next uncoupled restart — or the remaining blocks for a tail
    section), parsing further as needed.  ``None`` when the substream
    periods disagree or the frame length does not divide the period."""
    v = st["v"]
    L0 = int(v.frame_len[f0])
    if L0 <= 0:
        return None
    struct = []
    for s in range(v.substream_count):
        B = blk0s[s]
        if st["v"].sub[s]["len"].shape[0] <= B:
            return None
        S0 = int(st["v"].sub[s]["len"][B])
        NB0 = None
        while NB0 is None:
            sub = st["v"].sub[s]
            restart = sub["restart"][B + 1 :]
            coupled = sub["fir_any"][B + 1 : B + 1 + restart.shape[0]] != 0
            fresh = np.nonzero(restart & ~coupled)[0]
            if fresh.size:
                NB0 = int(fresh[0]) + 1
            elif not st["more"]:
                NB0 = sub["len"].shape[0] - B  # single-chain tail section
            else:
                parse_step(st["v"].F)  # double the coverage
        if NB0 <= 0:
            return None
        struct.append((s, S0, NB0))
    periods = {S0 * NB0 for _, S0, NB0 in struct}
    if len(periods) != 1:
        return None
    period = periods.pop()
    if period % L0:
        return None
    return L0, period, period // L0, struct


def _verified_chains(v, struct, L0, fpc, f0, blk0s, c0, c1, done) -> int:
    """How many chains of [c0, c1) (section-relative) verify under the
    section geometry: all frames of length ``L0``, all blocks of size
    ``S0``, an uncoupled restart at the start (except the stream's block
    0), no internal chain split, and a fresh chain start (or the exact
    stream end) after.  The count stops at the first failing chain."""
    nc = c1 - c0
    ok = np.ones(nc, bool)
    fa = f0 + c0 * fpc
    fl = v.frame_len[fa : fa + nc * fpc]
    ok &= (fl.reshape(nc, fpc) == L0).all(axis=1)
    for s, S0, NB0 in struct:
        sub = v.sub[s]
        a = blk0s[s] + c0 * NB0
        nbk = sub["len"].shape[0]
        span = nc * NB0
        lens = sub["len"][a : a + span].reshape(nc, NB0)
        ok &= (lens == S0).all(axis=1)
        restart = sub["restart"][a : a + span]
        coupled = sub["fir_any"][a : a + span] != 0
        unc = (restart & ~coupled).reshape(nc, NB0)
        start_ok = unc[:, 0].copy()
        if a == 0:
            start_ok[0] = True  # the stream's block 0 starts a chain
        ok &= start_ok
        if NB0 > 1:
            ok &= ~unc[:, 1:].any(axis=1)
        nxt = a + (np.arange(nc) + 1) * NB0
        end_ok = (nxt == nbk) & done
        inb = nxt < nbk
        idx = nxt[inb]
        if idx.size:
            end_ok[inb] = sub["restart"][idx] & (sub["fir_any"][idx] == 0)
        ok &= end_ok
    bad = np.nonzero(~ok)[0]
    return int(bad[0]) if bad.size else nc


class _ParseBail(Exception):
    """The native parser handed the stream back (its ``bail_reason``)."""


def _bail_text(parse) -> str:
    return host.bail_reason_text(getattr(parse, "bail_reason", 0))


def _warn_bail(parse) -> None:
    """Name WHY the native parser handed the stream back: the fallback is
    the pure-Python engines, orders of magnitude slower, and a silent mode
    switch of that size must be diagnosable (dvda_tpu's ``_warn_bail``)."""
    logger.warning(
        "native MLP parse bailed: %s; falling back to the pure-Python "
        "engines (orders of magnitude slower)", _bail_text(parse))


def decode_native(stream: bytes, boundaries: np.ndarray, probe_end: int,
                  parameters: StreamParameters, want_packed: bool = False,
                  config: DecodeConfig | None = None,
                  info: dict | None = None) -> np.ndarray | None:
    """Decode a complete MLP stream on ``config.device``.  Returns int32
    ``[T, C]`` samples or — with ``want_packed`` on a 16/24-bit stream —
    uint8 ``[T, C*nbytes]`` little-endian WAV data bytes.

    The native parser runs in frame batches interleaved with chunk
    dispatch, so parsing of chunk N+1 overlaps chunk N's kernels and d2h
    copy.  With ``config.device_huffman`` the parse skips the residual
    values and K5 decodes them on the device (dvda_tpu's
    native_engine.py:598-610).  A stream the pipelined driver abandons is
    decoded whole by :func:`_decode_parsed` (dvda_tpu's :611-628): in
    device-Huffman mode after a second parse in value mode.  On the
    general path the result is int32 ``[T, C]`` even with
    ``want_packed``, as in dvda_tpu.  ``info``, when given, receives
    ``path`` (``"pipelined"``, ``"uniform"`` or ``"general"``) and, from
    the pipelined driver, ``sections`` and ``chunks``.  Raises
    ``RuntimeError`` without the native library or without the requested
    CUDA device.  When the parser bails it logs a warning naming the
    reason and returns None (chunks already dispatched are dropped): the
    caller decodes with the Python engines."""
    cfg = config if config is not None else default_config()
    device = cfg.resolved_device()
    if not host.available():
        raise RuntimeError("the native host library (dvda_tpu_torch/host) "
                           "could not be built; the port has no other "
                           "parser")
    info = info if info is not None else {}
    huffman = bool(cfg.device_huffman)
    inc = host.parse_mlp_stream_begin(
        stream, skip_values=huffman, threads=cfg.resolved_parse_threads(),
        sub_every=cfg.resolved_huffman_split() if huffman else 0)
    try:
        res = _decode_pipelined(inc, stream, boundaries, probe_end,
                                parameters, want_packed, cfg, device, info)
        if res is not _ABANDON:
            return res
        if huffman:
            # the general path needs residual values: parse again
            inc.close()
            inc = host.parse_mlp_stream_begin(
                stream, threads=cfg.resolved_parse_threads())
        with global_timer.stage("mlp/native-parse"):
            inc.step(0)  # finish the walk; no bytes are re-parsed
        parse = inc.view()
        if parse.status != 0:
            _warn_bail(parse)
            return None
        return _decode_parsed(parse, boundaries, probe_end, parameters,
                              want_packed, cfg, device, info)
    finally:
        inc.close()  # frees the zero-copy parse buffers


def _decode_pipelined(inc, stream, boundaries, probe_end, parameters,
                      want_packed, cfg, device, info):
    """The pipelined driver; ``_ABANDON`` for the whole-parse path, or None
    when the parser bails (after the chunks already pushed are dropped and
    the reason is logged)."""
    st = {"more": True, "drain": None}
    try:
        return _pipelined(st, inc, stream, boundaries, probe_end, parameters,
                          want_packed, cfg, device, info)
    except _ParseBail:
        if st["drain"] is not None:
            st["drain"].discard()
        _warn_bail(st["v"])
        return None


def _pipelined(st, inc, stream, boundaries, probe_end, parameters,
               want_packed, cfg, device, info):
    out_ch = parameters.channel_count
    pack_bits = _pack_bits(parameters.bits_per_sample)
    CHUNK = cfg.resolved_chunk_chains(out_ch)
    cuda = device.type == "cuda"
    huffman = bool(cfg.device_huffman)

    def parse_step(n):
        with global_timer.stage("mlp/native-parse"):
            st["more"] = inc.step(n)
        st["v"] = inc.view()
        if st["v"].status != 0:
            raise _ParseBail

    parse_step(64)
    while st["more"] and st["v"].F == 0:  # leading frames may all drop
        parse_step(64)
    if st["v"].F == 0:
        return _ABANDON  # empty or degenerate: the whole-parse path

    words = _SharedWords(stream, cuda) if huffman else None
    devices = _decode_devices(cfg) or [device]
    tier0 = _narrow_tier0(pack_bits, out_ch, cfg)
    drain = None
    ci = 0
    mat_mm = 0                               # running rematrix slot bound
    f0 = 0                                   # frame base of the section
    blk0s = [0] * st["v"].substream_count    # per-substream block bases
    suboffs = [0] * st["v"].substream_count  # flat sub_bitpos offsets
    t_base = 0                               # absolute sample base
    n_sections = 0
    prev_key = None
    while True:
        while st["more"] and st["v"].F <= f0:
            parse_step(64)
        if st["v"].F <= f0:
            break  # every parsed frame is covered
        key = (f0, tuple(blk0s))
        n_sections += 1
        geo = (None if key == prev_key or n_sections > 8  # no progress;
               else _discover_geometry(st, parse_step, f0, blk0s))  # churn
        if geo is None:
            if drain is not None:
                drain.discard()  # chunks already pushed are dropped
            return _ABANDON
        prev_key = key
        L0, period, fpc, struct = geo  # struct: (s, S0, NB0)

        c0 = 0
        while True:
            need_f = f0 + (c0 + CHUNK) * fpc + 1
            while st["more"] and st["v"].F < need_f:
                parse_step(max(64, need_f - st["v"].F))
            v = st["v"]
            avail = min((v.F - f0) // fpc,
                        *((v.sub[s]["len"].shape[0] - blk0s[s]) // NB0
                          for s, _, NB0 in struct))
            want = min(c0 + CHUNK, avail)
            if want <= c0:
                break  # section exhausted (a tail opens a new section)
            n_ok = _verified_chains(v, struct, L0, fpc, f0, blk0s, c0, want,
                                    not st["more"])
            if n_ok == 0:
                break  # geometry broke at c0: close the section here
            c1 = c0 + n_ok
            if drain is None:
                # size the output from the parse so far: samples per
                # stream byte, plus one chunk of slack
                per_byte = v.T / max(1, int(v.frame_end[v.F - 1]))
                drain = st["drain"] = _drain_for(
                    device, out_ch, pack_bits,
                    int(per_byte * len(stream) * 1.125) + CHUNK * period,
                    tier0, cfg.drain_thread)
            dev = devices[ci % len(devices)]  # chunk round-robin
            with global_timer.stage("mlp/arena-build"):
                subs_info = [(v.sub[s], blk0s[s], S0, NB0, suboffs[s])
                             for s, S0, NB0 in struct]
                mat_mm = max(mat_mm, _max_matrix_slots(
                    v.mat_active[f0 + c0 * fpc : f0 + c1 * fpc]))
                (a4, a2, a1), spec = _build_chunk_arenas(
                    v, subs_info, c0, c1, CHUNK, period, L0, out_ch,
                    pack_bits, f0, t_base, mat_mm, pin=cuda, huffman=huffman,
                    narrow=drain.tier, native=cfg.native_pack)
            with global_timer.stage("mlp/chunk-launch"):
                out, tier, redo = _chunk_program(
                    *arenas_to_device(a4, a2, a1, spec, dev), spec,
                    words.on(dev) if words is not None else None)
                drain.push(out, n_ok * period, tier, redo)
            drain.throttle()
            ci += 1
            c0 = c1
            if c1 < want:  # verification truncated: geometry broke
                break
        # close the section: advance every base past its verified chains
        f0 += c0 * fpc
        t_base += c0 * period
        for s, S0, NB0 in struct:
            blk0s[s] += c0 * NB0
            k = int(st["v"].sub[s].get("sub_every", 0) or 0)
            if k:  # ceil(S0/k) flat sub_bitpos entries per block
                suboffs[s] += c0 * NB0 * (-(-S0 // k))
        if not st["more"] and st["v"].F <= f0:
            break

    info.update(path="pipelined", sections=n_sections, chunks=ci)
    v = st["v"]
    F = _frame_cut(v.frame_end, np.asarray(boundaries, dtype=np.int64),
                   probe_end)
    if F == 0 or drain is None:
        return np.zeros((0, out_ch), dtype=np.int32)
    T = int(v.frame_len[:F].sum())
    with global_timer.stage("mlp/device+d2h"):
        raw = drain.finish(T)
    _narrow_info(info, drain)
    return _unpack_raw(raw, T, out_ch, pack_bits, want_packed)


def _drain_for(device, out_ch: int, pack_bits: int, capacity: int,
               tier: int, side: bool = True) -> _Drain:
    """The drain of a stream's chunks: rows of ``out_ch`` samples of
    ``pack_bits`` bits as bytes (int32 when 0), narrow from ``tier``;
    ``side`` = ``DecodeConfig.drain_thread``."""
    if pack_bits:
        return _Drain(device, out_ch * pack_bits // 8, torch.uint8, capacity,
                      tier, side)
    return _Drain(device, out_ch * 4, torch.int32, capacity, side=side)


def _decode_devices(cfg: DecodeConfig):
    """The devices the chunks go round-robin over (chunk ``i`` on device
    ``i % n``), or None for the one decode device — dvda_tpu's
    ``_decode_devices`` (:1633-1647).  Chain chunks are independent (no
    state crosses a chunk), so a multi-GPU decode is data parallelism over
    chunks.  A list only with ``multi_device`` on, a CUDA decode device
    and more than one visible CUDA device: on one card, or on the CPU, the
    decode is the one-device decode."""
    if not cfg.multi_device or torch.device(cfg.device).type != "cuda":
        return None
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n > 1 else None


def _narrow_info(info: dict, drain: _Drain) -> None:
    """The narrow readback's record of a decode: the tier the track
    settled at (0: wide), the chunks run again wider, the bytes drained."""
    info.update(tier=drain.tier, redone=drain.redone, drained=drain.drained)


def _decode_parsed(parse, boundaries, probe_end, parameters, want_packed,
                   cfg, device, info):
    """Decode a finished parse whole (dvda_tpu's ``_decode_parsed``,
    :1413-1523): the frame cut, then :func:`_try_uniform`, else the
    general path's host tables and :func:`~dvda_tpu_torch.ops.
    general_gather.general_pipeline` on ``device``."""
    out_ch = parameters.channel_count
    if parse.F == 0:
        return np.zeros((0, out_ch), dtype=np.int32)
    F = _frame_cut(parse.frame_end, np.asarray(boundaries, dtype=np.int64),
                   probe_end)
    if F == 0:
        return np.zeros((0, out_ch), dtype=np.int32)
    frame_len = parse.frame_len[:F]
    T = int(frame_len.sum())
    out = _try_uniform(parse, F, frame_len, T, out_ch,
                       parameters.bits_per_sample, want_packed, cfg, device,
                       info)
    if out is not None:
        info["path"] = "uniform"
        return out
    info["path"] = "general"
    with global_timer.stage("mlp/general-tables"):
        subs, frames = general_tables(parse, F, T, out_ch, device)
    with global_timer.stage("mlp/general"):
        return general_pipeline(subs, frames).cpu().numpy()


def general_tables(parse, F: int, T: int, out_ch: int, device):
    """The general path's inputs for the first ``F`` frames (``T``
    samples) of a finished value-mode parse, as tensors on ``device``:
    (per-substream tables, frame tables) — the arguments of
    :func:`~dvda_tpu_torch.ops.general_gather.general_pipeline`."""
    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    subs = []
    for s in range(parse.substream_count):
        tab = substream_tables(parse.sub[s], F, T)
        S = tab.pop("S")
        subs.append({k: up(v) for k, v in tab.items()} | {"S": S})
    frames = (np.concatenate([[0], np.cumsum(parse.frame_len[:F],
                                             dtype=np.int64)]),
              np.stack([parse.noise0[:T], parse.noise1[:T]], 1),
              parse.bypassed_packed[:T], parse.mat_coeff[:F],
              parse.mat_noise[:F], parse.mat_out[:F], parse.mat_active[:F],
              parse.mat_quant[:F], parse.out_shift[:F],
              _wave_perm(parse, out_ch))
    return subs, tuple(up(x) for x in frames)


def _try_uniform(parse, F, frame_len, T, out_ch, bits_per_sample,
                 want_packed, cfg, device, info):
    """The whole stream through the arena chunk program (K1, K234) when it
    is uniform — one frame length, one block size and one chain length
    per substream, the same chain count and period in every substream —
    else None (dvda_tpu's ``_try_uniform``, :1533-1631)."""
    L0 = int(frame_len[0])
    if not (frame_len == L0).all():
        return None
    subs_info = []
    n_chains = None
    period = None  # samples per chain, must agree across substreams
    for s_idx in range(parse.substream_count):
        sub = parse.sub[s_idx]
        nb_keep = int(sub["fr_nblocks"][:F].sum())
        if nb_keep == 0:
            return None
        lens = sub["len"][:nb_keep]
        S0 = int(lens[0])
        if not (lens == S0).all():
            return None
        chain_lens = restart_chains(sub, nb_keep)[1]
        NB0 = int(chain_lens[0])
        if not (chain_lens == NB0).all():
            return None
        nc = nb_keep // NB0
        per = NB0 * S0
        if n_chains is None:
            n_chains, period = nc, per
        elif nc != n_chains or per != period:
            return None
        subs_info.append((sub, 0, S0, NB0, 0))  # whole-stream: base 0
    if period % L0:
        return None

    CHUNK = cfg.resolved_chunk_chains(out_ch)
    pack_bits = _pack_bits(bits_per_sample)
    cuda = device.type == "cuda"
    fpc = period // L0
    mat_mm = 0
    devices = _decode_devices(cfg) or [device]
    drain = _drain_for(device, out_ch, pack_bits, n_chains * period,
                       _narrow_tier0(pack_bits, out_ch, cfg),
                       cfg.drain_thread)
    ci = 0
    for ci, c0 in enumerate(range(0, n_chains, CHUNK), 1):
        c1 = min(c0 + CHUNK, n_chains)
        with global_timer.stage("mlp/arena-build"):
            mat_mm = max(mat_mm, _max_matrix_slots(
                parse.mat_active[c0 * fpc : c1 * fpc]))
            (a4, a2, a1), spec = _build_chunk_arenas(
                parse, subs_info, c0, c1, CHUNK, period, L0, out_ch,
                pack_bits, 0, 0, mat_mm, pin=cuda, narrow=drain.tier,
                native=cfg.native_pack)
        with global_timer.stage("mlp/chunk-launch"):
            out, tier, redo = _chunk_program(*arenas_to_device(
                a4, a2, a1, spec, devices[(ci - 1) % len(devices)]), spec)
            drain.push(out, (c1 - c0) * period, tier, redo)
        drain.throttle()
    info["chunks"] = ci
    with global_timer.stage("mlp/device+d2h"):
        raw = drain.finish(T)
    _narrow_info(info, drain)
    return _unpack_raw(raw, T, out_ch, pack_bits, want_packed)


def decode_host_complete(stream: bytes, boundaries: np.ndarray,
                         probe_end: int, parameters: StreamParameters,
                         want_packed: bool = False,
                         threads: int = 1) -> np.ndarray:
    """The same stream reconstructed entirely by the C++ host runtime
    (``mp_reconstruct``: filter, rematrix, output stage and pack on the
    host; no device work).  The decode never picks it: it is the
    independent reference callers ask for (``chip_smoke.py`` holds the
    card's bytes against it)."""
    if not host.available():
        raise RuntimeError("the native host library could not be built")
    inc = host.parse_mlp_stream_begin(stream, threads=threads)
    try:
        with global_timer.stage("mlp/native-parse"):
            inc.step(0)
        parse = inc.view()
        if parse.status != 0:
            raise RuntimeError(f"native MLP parse bailed: {_bail_text(parse)}"
                               "; host-complete has no other parser")
        out_ch = parameters.channel_count
        F = _frame_cut(parse.frame_end,
                       np.asarray(boundaries, dtype=np.int64), probe_end)
        if F == 0:
            return np.zeros((0, out_ch), dtype=np.int32)
        pb = _pack_bits(parameters.bits_per_sample) if want_packed else 0
        with global_timer.stage("mlp/host-recon"):
            return parse.reconstruct(F, out_ch, pb, _wave_perm(parse, out_ch),
                                     threads=threads)
    finally:
        inc.close()

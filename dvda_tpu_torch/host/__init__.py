"""Native host runtime: ctypes bindings for libdvda_host.so.

The port's own copy of dvda_tpu/host (this file and src/*.cc; a fix to
either copy lands in both).  The shared library (built from src/*.cc with
g++, no external deps) holds the host-side hot paths: the MLP stream
parser + Huffman residual decoder (src/mlp_parse.cc), the packet demux
(src/demux.cc), the PCM repack (src/pcm_repack.cc) and the CPPM C2 cipher
(src/c2.cc).  The library is (re)built on first use into the gitignored
``build/dvda_tpu_torch/libdvda_host.so``, beside the CUDA kernels: under a
file lock, into a temporary name that is then renamed into place, so that
concurrent test workers neither race nor load half a library.  When a
toolchain is unavailable every entry point reports unavailable.

``parse_mlp_stream`` returns a :class:`NativeParse` exposing numpy views
of the parser's output arrays:

* frame-level: ``frame_len[F]``, ``frame_end[F]`` (byte offsets for the
  packet-boundary cut), ``out_shift[F,8]``, matrix tensors ``[F,6,…]``,
  noise channels ``noise0/noise1[T]`` plus per-frame LFSR seeds,
  bit-packed ``bypassed[T]`` (bit m = matrix slot m);
* per substream ``s``: ``blk_len[NB]``, ``blk_restart[NB]``, per-channel
  ``shift/quant/iir_reset[NB,n_ch]``, reversed-tap ``rc_fir/rc_iir/
  iir_init[NB,n_ch,8]`` and ragged ``residuals`` ordered
  (block, channel, sample).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

__all__ = ["available", "parse_mlp_stream", "parse_mlp_stream_begin",
           "NativeParse", "IncrementalParse",
           "c2_decrypt_sectors", "assemble_mlp_stream"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                   "dvda_tpu_torch", "libdvda_host.so")
_SOURCES = [os.path.join(_DIR, "src", f)
            for f in ("mlp_parse.cc", "c2.cc", "demux.cc",
                      "pcm_repack.cc")]

_lib = None
_load_error: str | None = None


def _build() -> bool:
    sources = [s for s in _SOURCES if os.path.exists(s)]
    if not sources:
        return False
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return True  # another process built it while we waited
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-pthread", "-std=c++17", "-o", tmp] + sources,
                check=True, capture_output=True,
            )
            os.replace(tmp, _SO)
            return True
        except (subprocess.CalledProcessError, OSError):
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    so_m = os.path.getmtime(_SO)
    return any(os.path.exists(s) and os.path.getmtime(s) > so_m for s in _SOURCES)


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    if _stale() and not _build():
        _load_error = "native host library could not be built"
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as exc:
        _load_error = str(exc)
        return None
    c = ctypes
    lib.mlp_parse.restype = c.c_void_p
    lib.mlp_parse.argtypes = [c.c_char_p, c.c_int64, c.c_void_p, c.c_void_p]
    # (mlp_parse_begin / mlp_parse_begin2 stay exported for ABI
    # compatibility but every Python caller routes through the MT entry)
    lib.mlp_parse_begin_mt.restype = c.c_void_p
    lib.mlp_parse_begin_mt.argtypes = [c.c_char_p, c.c_int64, c.c_void_p,
                                       c.c_void_p, c.c_int32, c.c_int32]
    lib.mlp_parse_step.restype = c.c_int32
    lib.mlp_parse_step.argtypes = [c.c_void_p, c.c_int64]
    lib.mp_skip_values.restype = c.c_int32
    lib.mp_skip_values.argtypes = [c.c_void_p]
    lib.mp_blk_res_bitpos.restype = c.POINTER(c.c_int64)
    lib.mp_blk_res_bitpos.argtypes = [c.c_void_p, c.c_int32]
    for name in ("mp_blk_codebook", "mp_blk_lsb_bits", "mp_blk_res_offset"):
        fn = getattr(lib, name)
        fn.restype = c.POINTER(c.c_int32)
        fn.argtypes = [c.c_void_p, c.c_int32]
    for name in ("mp_blk_nbyp", "mp_blk_byp_mask"):
        fn = getattr(lib, name)
        fn.restype = c.POINTER(c.c_uint8)
        fn.argtypes = [c.c_void_p, c.c_int32]
    lib.mp_pack.restype = c.c_int32
    lib.mp_pack.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                            c.c_void_p, c.c_void_p, c.c_void_p,
                            c.c_int64, c.c_int64, c.c_int64]
    lib.mp_reconstruct.restype = c.c_int64
    lib.mp_reconstruct.argtypes = [c.c_void_p, c.c_int64, c.c_int32,
                                   c.c_int32, c.c_void_p, c.c_void_p,
                                   c.c_int64, c.c_int32]
    lib.mp_widen24.restype = None
    lib.mp_widen24.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
    lib.mp_pool_clear.restype = None
    lib.mp_pool_clear.argtypes = []
    lib.mp_pcm_repack.restype = None
    lib.mp_pcm_repack.argtypes = [c.c_void_p, c.c_int64, c.c_int32,
                                  c.c_void_p, c.c_int32, c.c_void_p,
                                  c.c_int64]
    lib.mp_widen12.restype = None
    lib.mp_widen12.argtypes = [c.c_void_p, c.c_int64, c.c_void_p]
    lib.mp_sub_every.restype = c.c_int32
    lib.mp_sub_every.argtypes = [c.c_void_p]
    lib.mp_fill_noise.restype = None
    lib.mp_fill_noise.argtypes = [c.c_void_p]
    lib.mp_blk_sub_bitpos.restype = c.POINTER(c.c_int32)
    lib.mp_blk_sub_bitpos.argtypes = [c.c_void_p, c.c_int32]
    lib.mp_blk_sub_bitpos_size.restype = c.c_int64
    lib.mp_blk_sub_bitpos_size.argtypes = [c.c_void_p, c.c_int32]
    lib.mp_sub_span_max.restype = c.c_int32
    lib.mp_sub_span_max.argtypes = [c.c_void_p, c.c_int32]
    for name in ("mp_mt_repairs", "mp_mt_full_redo", "mp_frame_pairs",
                 "mp_pair_falls"):
        fn = getattr(lib, name)
        fn.restype = c.c_int64
        fn.argtypes = [c.c_void_p]
    lib.mp_merge_stats.restype = None
    lib.mp_merge_stats.argtypes = [c.c_void_p, c.c_void_p]
    lib.mlp_parse_free.argtypes = [c.c_void_p]
    for name, res in [
        ("mp_status", c.c_int32), ("mp_bail_reason", c.c_int32),
        ("mp_substream_count", c.c_int32),
        ("mp_mmc", c.c_int32), ("mp_assignment", c.c_int32),
        ("mp_nframes", c.c_int64), ("mp_total_samples", c.c_int64),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [c.c_void_p]
    for name in ("mp_min_ch", "mp_max_ch"):
        fn = getattr(lib, name)
        fn.restype = c.c_int32
        fn.argtypes = [c.c_void_p, c.c_int32]
    lib.mp_nblocks.restype = c.c_int64
    lib.mp_nblocks.argtypes = [c.c_void_p, c.c_int32]
    lib.mp_residuals_size.restype = c.c_int64
    lib.mp_residuals_size.argtypes = [c.c_void_p, c.c_int32]
    for name in ("mp_frame_len", "mp_out_shift", "mp_mat_out", "mp_mat_quant",
                 "mp_mat_coeff", "mp_mat_noise", "mp_noise0", "mp_noise1"):
        fn = getattr(lib, name)
        fn.restype = c.POINTER(c.c_int32)
        fn.argtypes = [c.c_void_p]
    lib.mp_frame_end.restype = c.POINTER(c.c_int64)
    lib.mp_frame_end.argtypes = [c.c_void_p]
    for name in ("mp_mat_active", "mp_bypassed"):
        fn = getattr(lib, name)
        fn.restype = c.POINTER(c.c_uint8)
        fn.argtypes = [c.c_void_p]
    lib.mp_frame_seed.restype = c.POINTER(c.c_uint32)
    lib.mp_frame_seed.argtypes = [c.c_void_p]
    lib.mp_frame_nshift.restype = c.POINTER(c.c_int32)
    lib.mp_frame_nshift.argtypes = [c.c_void_p]
    lib.c2_decrypt_sectors.restype = c.c_int64
    lib.c2_decrypt_sectors.argtypes = [c.c_void_p, c.c_int64, c.c_uint64,
                                       c.c_uint64, c.c_int32]
    for name in ("mp_fr_nblocks", "mp_blk_len", "mp_blk_shift",
                 "mp_blk_quant", "mp_blk_rc_fir",
                 "mp_blk_rc_iir", "mp_blk_iir_init", "mp_residuals"):
        fn = getattr(lib, name)
        fn.restype = c.POINTER(c.c_int32)
        fn.argtypes = [c.c_void_p, c.c_int32]
    for name in ("mp_blk_restart", "mp_blk_iir_reset",
                 "mp_blk_param_update", "mp_blk_fir_any"):
        fn = getattr(lib, name)
        fn.restype = c.POINTER(c.c_uint8)
        fn.argtypes = [c.c_void_p, c.c_int32]
    lib.dvda_demux_feed.restype = c.c_int64
    lib.dvda_demux_feed.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_int64, c.c_int64,
        c.c_void_p, c.c_int64, c.c_void_p, c.c_int64, c.c_void_p]
    lib.dvda_demux_finish.argtypes = [c.c_void_p, c.c_void_p]
    lib.mp_res_amax.restype = c.c_int32
    lib.mp_res_amax.argtypes = [c.c_void_p, c.c_int32]
    lib.dvda_pcm_feed.restype = c.c_int64
    lib.dvda_pcm_feed.argtypes = [
        c.c_void_p, c.c_void_p, c.c_int64, c.c_uint8, c.c_uint8, c.c_uint8,
        c.c_int64, c.c_void_p, c.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def alloc_bytearray(n: int) -> bytearray:
    """bytearray of ``n`` uninitialized bytes — callers fully overwrite
    it (reconstruct/pcm_repack/drain outputs).  The zeroing constructor
    costs a full memset pass (~10 ms per 52 MB track); CPython's
    ``PyByteArray_FromStringAndSize(NULL, n)`` documents the contents as
    uninitialized.  Falls back to the plain constructor."""
    try:
        f = ctypes.pythonapi.PyByteArray_FromStringAndSize
        f.restype = ctypes.py_object
        f.argtypes = [ctypes.c_char_p, ctypes.c_ssize_t]
        return f(None, int(n))
    except Exception:  # pragma: no cover - non-CPython fallback
        return bytearray(int(n))


def pcm_repack(chunks: "np.ndarray", table: "np.ndarray",
               out_per_chunk: int, max_bytes: int):
    """Repack PCM chunk bytes straight into WAV payload bytes through one
    composed gather table (mp_pcm_repack) — see host/src/pcm_repack.cc.
    ``chunks``: uint8 [n, csize] C-contiguous.  ``table``: int32
    [out_per_chunk], source index per output byte (-1 → 0).  Returns a
    bytearray of ``max_bytes`` WAV data bytes, or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    assert chunks.dtype == np.uint8 and chunks.flags["C_CONTIGUOUS"]
    table = np.ascontiguousarray(table, dtype=np.int32)
    assert table.shape == (out_per_chunk,)
    buf = alloc_bytearray(int(max_bytes))
    avail = chunks.shape[0] * int(out_per_chunk)
    if len(buf) > avail:  # uninitialized tail beyond the chunk data
        buf[avail:] = bytes(len(buf) - avail)
    lib.mp_pcm_repack(
        chunks.ctypes.data_as(ctypes.c_void_p), chunks.shape[0],
        chunks.shape[1], table.ctypes.data_as(ctypes.c_void_p),
        int(out_per_chunk),
        (ctypes.c_char * len(buf)).from_buffer(buf) if buf else None,
        len(buf))
    return buf


def pool_clear() -> None:
    """Release every arena block held by the native large-block pool
    (mp_pool_clear).  The pool is self-limiting (DVDA_HOST_POOL_MB,
    default 384 MiB) and recycles parse/reconstruction arenas across
    decodes; call this to return the memory to the OS immediately, e.g.
    after a batch job."""
    lib = _load()
    if lib is not None:
        lib.mp_pool_clear()


def widen24(pairs: np.ndarray, dst: np.ndarray) -> bool:
    """Widen contiguous little-endian int16 sample bytes (``pairs``,
    uint8 [n, 2] or flat [2n]) into the 24-bit WAV byte layout ``dst``
    (uint8, 3n bytes, C-contiguous): triple = (lo, hi, sign-ext of hi).
    Returns False when the native library is unavailable (caller falls
    back to numpy)."""
    lib = _load()
    if lib is None:
        return False
    pairs = np.ascontiguousarray(pairs, dtype=np.uint8)
    assert dst.flags["C_CONTIGUOUS"] and dst.dtype == np.uint8
    n = pairs.size // 2
    assert dst.size == 3 * n
    lib.mp_widen24(pairs.ctypes.data_as(ctypes.c_void_p), n,
                   dst.ctypes.data_as(ctypes.c_void_p))
    return True


def widen12(triples: np.ndarray, dst: np.ndarray) -> bool:
    """Widen 12-bit-tier bytes (``triples``, uint8, 3 bytes per channel
    PAIR: c0 = b0 | (b1&0xF)<<8, c1 = b1>>4 | b2<<4, both 12-bit signed)
    into the 24-bit WAV byte layout ``dst`` (uint8, 6 bytes per triple,
    C-contiguous).  Returns False when the native library is unavailable
    (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return False
    triples = np.ascontiguousarray(triples, dtype=np.uint8)
    assert dst.flags["C_CONTIGUOUS"] and dst.dtype == np.uint8
    n = triples.size // 3
    assert dst.size == 6 * n
    lib.mp_widen12(triples.ctypes.data_as(ctypes.c_void_p), n,
                   dst.ctypes.data_as(ctypes.c_void_p))
    return True


# Wrapping C pointers via memoryviews: np.ctypeslib.as_array builds a new
# ctypes array *type* per distinct length (~0.5 ms each), which made every
# IncrementalParse.view() snapshot cost ~20 ms — quadratic over a pipelined
# decode.  PyMemoryView_FromMemory has no such per-shape cost.
ctypes.pythonapi.PyMemoryView_FromMemory.restype = ctypes.py_object
ctypes.pythonapi.PyMemoryView_FromMemory.argtypes = [
    ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int]
_PyBUF_WRITE = 0x200
_CTYPE_DTYPE = {
    ctypes.c_int32: np.dtype(np.int32), ctypes.c_int64: np.dtype(np.int64),
    ctypes.c_uint8: np.dtype(np.uint8), ctypes.c_uint32: np.dtype(np.uint32),
}


def _as_view(ptr, shape):
    """Zero-copy numpy view over the parser's output buffer (dtype is the
    pointer's own ctype).  Valid while the owning NativeParse is alive."""
    dtype = _CTYPE_DTYPE[ptr._type_]
    n = int(np.prod(shape)) if shape else 0
    if n == 0:
        return np.zeros(shape, dtype=dtype)
    mv = ctypes.pythonapi.PyMemoryView_FromMemory(
        ctypes.cast(ptr, ctypes.c_void_p), n * dtype.itemsize, _PyBUF_WRITE)
    return np.frombuffer(mv, dtype=dtype).reshape(shape)


def _as_np(ptr, dtype, shape):
    return _as_view(ptr, shape).astype(dtype, copy=True)


class NativeParse:
    """Numpy access to one parsed MLP stream.

    Large arrays (residuals, filter/matrix tensors, noise) are **zero-copy
    views** into the native parser's buffers — the handle is owned by this
    object and freed on :meth:`close`/GC, so the views must not outlive
    it.  Copying them cost ~100 MB of memcpy + page faults per 30 s track,
    which dominated the parse stage.  Small semantically-boolean arrays
    are converted (copied) for engine ergonomics."""

    @property
    def noise0(self) -> np.ndarray:
        """Per-sample noise channel 0 [T] (mlp.c noise generator).  The
        parser defers this 2xT expansion (the device pipeline expands
        noise on-chip from ``frame_seed``); first access fills it
        on demand.  Like every other view, re-fetch after step()."""
        if self._h is None:
            return np.zeros(0, np.int32)
        self._lib.mp_fill_noise(self._h)
        return _as_view(self._lib.mp_noise0(self._h), (self.T,))

    @property
    def noise1(self) -> np.ndarray:
        """Per-sample noise channel 1 [T]; see :attr:`noise0`."""
        if self._h is None:
            return np.zeros(0, np.int32)
        self._lib.mp_fill_noise(self._h)
        return _as_view(self._lib.mp_noise1(self._h), (self.T,))

    def __init__(self, lib, h, owns: bool = True):
        self._owns = owns
        self._lib, self._h = lib, (h if lib.mp_status(h) == 0 else None)
        self.status = lib.mp_status(h)
        self.bail_reason = int(lib.mp_bail_reason(h))
        if self.status != 0:
            if owns:
                lib.mlp_parse_free(h)
            return
        self.substream_count = lib.mp_substream_count(h)
        self.mmc = lib.mp_mmc(h)
        self.assignment = lib.mp_assignment(h)
        F = int(lib.mp_nframes(h))
        T = int(lib.mp_total_samples(h))
        self.F, self.T = F, T
        self.frame_len = _as_view(lib.mp_frame_len(h), (F,))
        self.frame_end = _as_view(lib.mp_frame_end(h), (F,))
        self.out_shift = _as_view(lib.mp_out_shift(h), (F, 8))
        self.mat_active = _as_np(lib.mp_mat_active(h), bool, (F, 6))
        self.mat_out = _as_view(lib.mp_mat_out(h), (F, 6))
        self.mat_quant = _as_view(lib.mp_mat_quant(h), (F, 6))
        self.mat_coeff = _as_view(lib.mp_mat_coeff(h), (F, 6, 8))
        self.mat_noise = _as_view(lib.mp_mat_noise(h), (F, 6, 2))
        self.frame_seed = _as_view(lib.mp_frame_seed(h), (F,))
        self.frame_nshift = _as_view(lib.mp_frame_nshift(h), (F,))
        self.bypassed_packed = _as_view(lib.mp_bypassed(h), (T,))
        self.skip_values = bool(lib.mp_skip_values(h))
        self.sub = []
        for s in range(self.substream_count):
            NB = int(lib.mp_nblocks(h, s))
            lo = lib.mp_min_ch(h, s)
            hi = lib.mp_max_ch(h, s)
            n_ch = hi - lo + 1
            rs = int(lib.mp_residuals_size(h, s))
            sub = {
                "min_ch": lo, "max_ch": hi, "NB": NB,
                "res_amax": int(lib.mp_res_amax(h, s)),
                "fr_nblocks": _as_view(lib.mp_fr_nblocks(h, s), (F,)),
                "restart": _as_np(lib.mp_blk_restart(h, s), bool, (NB,)),
                "param_update": _as_view(lib.mp_blk_param_update(h, s), (NB,)),
                "fir_any": _as_view(lib.mp_blk_fir_any(h, s), (NB,)),
                "len": _as_view(lib.mp_blk_len(h, s), (NB,)),
                "shift": _as_view(lib.mp_blk_shift(h, s), (NB, n_ch)),
                "quant": _as_view(lib.mp_blk_quant(h, s), (NB, n_ch)),
                "iir_reset": _as_np(lib.mp_blk_iir_reset(h, s), bool, (NB, n_ch)),
                "rc_fir": _as_view(lib.mp_blk_rc_fir(h, s), (NB, n_ch, 8)),
                "rc_iir": _as_view(lib.mp_blk_rc_iir(h, s), (NB, n_ch, 8)),
                "iir_init": _as_view(lib.mp_blk_iir_init(h, s), (NB, n_ch, 8)),
                "residuals": _as_view(lib.mp_residuals(h, s), (rs,)),
            }
            if self.skip_values:
                sub.update({
                    "res_bitpos": _as_view(lib.mp_blk_res_bitpos(h, s), (NB,)),
                    "codebook": _as_view(lib.mp_blk_codebook(h, s), (NB, n_ch)),
                    "lsb_bits": _as_view(lib.mp_blk_lsb_bits(h, s), (NB, n_ch)),
                    "res_offset": _as_view(lib.mp_blk_res_offset(h, s),
                                           (NB, n_ch)),
                    "nbyp": _as_view(lib.mp_blk_nbyp(h, s), (NB,)),
                    "byp_mask": _as_view(lib.mp_blk_byp_mask(h, s), (NB,)),
                })
                nsp = int(lib.mp_blk_sub_bitpos_size(h, s))
                if nsp:
                    # flat ceil(len/k)-per-block offsets (rel. res_bitpos)
                    sub["sub_bitpos"] = _as_view(
                        lib.mp_blk_sub_bitpos(h, s), (nsp,))
                    sub["sub_every"] = int(lib.mp_sub_every(h))
                sub["sub_span_max"] = int(lib.mp_sub_span_max(h, s))
            self.sub.append(sub)

    def reconstruct(self, n_frames: int, out_ch: int, pack_bits: int,
                    wave_perm: "np.ndarray",
                    threads: int = 1) -> "np.ndarray | None":
        """Host-complete reconstruction (mp_reconstruct): filter +
        rematrix + output shifts + WAVE mapping + packing, all in the
        native runtime.  Returns packed WAV payload bytes — uint8
        [T, out_ch*pack_bits/8] for pack_bits 16/24 — or int32
        [T, out_ch] samples for pack_bits 0; None when this parse can't
        be reconstructed (bail status or skip-values mode).  threads ≥ 2
        parallelizes the AR filter across substreams and the
        rematrix/pack across frame ranges, bit-identically."""
        if self._h is None or self.status != 0 or self.skip_values:
            return None
        if pack_bits not in (0, 16, 24):
            raise ValueError(f"pack_bits must be 0, 16 or 24: {pack_bits}")
        n_frames = min(int(n_frames), self.F)
        T = int(self.frame_len[:n_frames].sum())
        width = pack_bits // 8 if pack_bits else 4
        if pack_bits:
            # bytearray-backed so read_all_packed can hand the payload to
            # the caller without a tobytes() copy of the whole track;
            # uninitialized alloc is safe — mp_reconstruct either fills
            # all T*width bytes or the call errors out
            buf = alloc_bytearray(T * out_ch * width)
            out = np.frombuffer(buf, dtype=np.uint8).reshape(
                T, out_ch * width)
        else:
            out = np.empty((T, out_ch), dtype=np.int32)
        perm = np.ascontiguousarray(wave_perm, dtype=np.int32)
        if perm.shape != (out_ch,):
            raise ValueError("wave_perm must be int32 [out_ch]")
        got = self._lib.mp_reconstruct(
            self._h, n_frames, out_ch, pack_bits,
            perm.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
            max(1, int(threads)))
        if got != out.nbytes:
            raise RuntimeError(f"mp_reconstruct failed ({got})")
        return out

    def pack(self, inst: "np.ndarray", a4: "np.ndarray", a2: "np.ndarray",
             a1: "np.ndarray") -> None:
        """Execute an arena-pack instruction list (int64 [n, 12]) against
        this parse, writing into the three preallocated arena buffers —
        see mp_pack in host/src/mlp_parse.cc for the instruction format.

        Raises on malformed inputs instead of asserting: the C side
        interprets these buffers as raw pointers, so a wrong dtype or a
        non-contiguous array must be a loud error even under ``-O``."""
        if inst.dtype != np.int64 or not inst.flags.c_contiguous:
            raise ValueError("pack instructions must be contiguous int64")
        for arr, dt in ((a4, np.int32), (a2, np.int16), (a1, np.int8)):
            if arr.dtype != dt or not arr.flags.c_contiguous:
                raise ValueError(f"arena buffer must be contiguous {dt}")
        rc = self._lib.mp_pack(
            self._h, inst.ctypes.data_as(ctypes.c_void_p), inst.shape[0],
            a4.ctypes.data_as(ctypes.c_void_p),
            a2.ctypes.data_as(ctypes.c_void_p),
            a1.ctypes.data_as(ctypes.c_void_p),
            a4.size, a2.size, a1.size)
        if rc != 0:
            raise RuntimeError(f"mp_pack failed ({rc})")

    def close(self) -> None:
        if self._h is not None:
            if self._owns:
                self._lib.mlp_parse_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IncrementalParse:
    """Stepped MLP parse: interleave parsing with downstream work.

    ``step(n)`` parses up to ``n`` more frames and returns True while more
    input remains; ``view()`` builds a fresh :class:`NativeParse` snapshot
    over the arrays parsed so far.  The parser's buffers may REALLOC on
    every step, so a snapshot (and every numpy view hanging off it) is
    invalidated by the next ``step`` — re-call ``view()`` after stepping.
    The handle is owned here; snapshots are non-owning."""

    def __init__(self, lib, h):
        self._lib, self._h = lib, h

    def step(self, max_frames: int) -> bool:
        return bool(self._lib.mlp_parse_step(self._h, max_frames))

    @property
    def status(self) -> int:
        return int(self._lib.mp_status(self._h))

    @property
    def bail_reason(self) -> int:
        """BailReason code when ``status != 0`` (see BAIL_REASONS)."""
        return int(self._lib.mp_bail_reason(self._h))

    @property
    def mt_stats(self) -> tuple[int, int]:
        """(local ≤2-section repairs, whole-stream sequential redos) of
        the multi-threaded parse — diagnostics for corrupt-frame fuzz."""
        return (int(self._lib.mp_mt_repairs(self._h)),
                int(self._lib.mp_mt_full_redo(self._h)))

    def merge_stats(self) -> dict[str, int]:
        """The multi-threaded parse's merger thread: ``merged_ahead``,
        the sections it merged; ``merged_inline``, those ``step`` merged
        on the caller's thread (a bail, a repaired entry frame, a shape
        mismatch, a section past the reserved capacity); ``step_waits``,
        the ``step`` calls that had to wait for it; ``parse_sections``,
        the sections the stream was cut into; ``flushed_ahead``, the
        merges the merger has finished copying (it takes a section in
        one merge ahead of copying it).  All 0 on a sequential parse."""
        out = (ctypes.c_int64 * 5)()
        if self._h is not None:
            self._lib.mp_merge_stats(self._h, out)
        return dict(merged_ahead=out[0], merged_inline=out[1],
                    step_waits=out[2], parse_sections=out[3],
                    flushed_ahead=out[4])

    @property
    def pair_stats(self) -> tuple[int, int]:
        """(frame pairs decoded, pair attempts fallen back to serial) of
        the skip-mode frame-pair walk — single-thread parser only (MT
        section workers keep their own counters); tests pin pairs > 0 on
        pairable streams so the four-chain path cannot silently
        de-activate."""
        return (int(self._lib.mp_frame_pairs(self._h)),
                int(self._lib.mp_pair_falls(self._h)))

    def view(self) -> "NativeParse":
        return NativeParse(self._lib, self._h, owns=False)

    def close(self) -> None:
        if self._h is not None:
            self._lib.mlp_parse_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


#: bail-reason codes (mlp_parse.cc BailReason) → human-readable text; the
#: native parser reports WHY it handed the stream back so the ~1000×
#: pure-Python fallback cliff is diagnosable (VERDICT r3 #8)
BAIL_REASONS = {
    0: "no bail",
    1: "substream frame lengths disagree",
    2: "stream does not begin with a restart header",
    3: "channel range changes mid-stream",
    4: "max-matrix-channel changes mid-stream",
    5: "overlapping substream channel ranges",
}


def bail_reason_text(code: int) -> str:
    return BAIL_REASONS.get(int(code), f"unknown bail code {code}")


_LUTS = None


def _luts():
    global _LUTS
    if _LUTS is None:
        from ..codecs.mlp.codebooks import peek_lut

        vals = np.zeros((4, 512), dtype=np.int32)
        lens = np.zeros((4, 512), dtype=np.int32)
        for k in (1, 2, 3):
            v, l = peek_lut(k)
            vals[k], lens[k] = v, l
        _LUTS = (np.ascontiguousarray(vals), np.ascontiguousarray(lens))
    return _LUTS


def parse_mlp_stream(data: bytes) -> NativeParse | None:
    """Parse a complete MLP frame stream; ``None`` if the native library is
    unavailable.  Check ``result.status`` (0 = ok, 1 = fall back)."""
    lib = _load()
    if lib is None:
        return None
    vals, lens = _luts()
    h = lib.mlp_parse(data, len(data),
                      vals.ctypes.data_as(ctypes.c_void_p),
                      lens.ctypes.data_as(ctypes.c_void_p))
    # NativeParse owns the handle (zero-copy views); freed on close/GC
    return NativeParse(lib, h)


def parse_mlp_stream_begin(data: bytes, skip_values: bool = False,
                           threads: int = 1,
                           sub_every: int = 0) -> IncrementalParse | None:
    """Begin an incremental MLP parse (see :class:`IncrementalParse`);
    ``None`` if the native library is unavailable.

    With ``skip_values`` the residual bits are walked length-only and the
    parse emits per-block decode tables (``res_bitpos``/``codebook``/
    ``lsb_bits``/``res_offset``/``nbyp``/``byp_mask``) for the on-device
    residual kernel instead of decoded residual values.  ``sub_every=k``
    (k in 1..255, skip_values only) additionally records every k-th
    sample's bit offset per block (``sub_bitpos``, relative to the
    block's ``res_bitpos``), letting the kernel decode each k-sample run
    as an independent lane — S0/k× fewer sequential scan steps.

    With ``threads > 1`` the stream is split at full-restart frames
    (parser state-reset points) and parsed by that many worker threads
    concurrently, and a merger thread merges the completed sections in
    order; each ``step`` then waits for at least one section merged since
    the last ``step`` and shows all merged so far (``max_frames``
    granularity does not apply; ``step(0)`` waits for the whole stream).  Output is bit-identical
    to the sequential parse: a section whose entry frame drops is
    repaired by a local sequential reparse of at most two sections (the
    previous verified boundary through the damaged section's end) —
    mid-section drops need no repair at all, since each section starts at
    a full parser-state reset (see mlp_parse.cc mt_step)."""
    lib = _load()
    if lib is None:
        return None
    if not 0 <= int(sub_every) <= 255:
        raise ValueError(f"sub_every must be in 0..255, got {sub_every}")
    vals, lens = _luts()
    h = lib.mlp_parse_begin_mt(data, len(data),
                               vals.ctypes.data_as(ctypes.c_void_p),
                               lens.ctypes.data_as(ctypes.c_void_p),
                               (1 if skip_values else 0)
                               | (int(sub_every) << 8),
                               max(1, int(threads)))
    return IncrementalParse(lib, h)


def assemble_mlp_stream(aob, first_sector: int, last_sector: int,
                        batch: int = 4096):
    """Native demux + MLP stream assembly (src/demux.cc): the exact byte
    stream the pull decoder would feed, plus post-probe packet boundaries
    and the probe-prefix length.  Semantics mirror
    codecs/mlp/track.py:_assemble_stream; returns ``None`` when the native
    library is unavailable or the container is malformed during the probe
    (the Python path handles those).
    """
    lib = _load()
    if lib is None:
        return None
    c = ctypes
    state = np.zeros(10, dtype=np.int64)
    state[3] = -1  # ST_SYNC_OFF
    # the assembled stream cannot exceed the span's sector payload:
    # size once, no geometric regrow copies on multi-MB tracks
    span = max(int(last_sector) - int(first_sector) + 1, 1)
    stream = np.empty(min(span, 1 << 20) * 2048, dtype=np.uint8)
    bounds_cap = batch * 342  # > max audio packets per sector
    bounds_buf = np.empty(bounds_cap, dtype=np.int64)
    n_out = np.zeros(1, dtype=np.int64)
    boundaries: list[np.ndarray] = []
    sector = first_sector
    while True:
        sectors = aob.read_sectors(sector, batch)
        n = sectors.shape[0]
        if n == 0:
            break
        need = int(state[1]) + n * 2048
        if need > stream.shape[0]:
            grown = np.empty(max(need, 2 * stream.shape[0]), dtype=np.uint8)
            grown[: int(state[1])] = stream[: int(state[1])]
            stream = grown
        sectors = np.ascontiguousarray(sectors)
        rc = lib.dvda_demux_feed(
            state.ctypes.data_as(c.c_void_p),
            sectors.ctypes.data_as(c.c_void_p), n, sector, last_sector,
            stream.ctypes.data_as(c.c_void_p), stream.shape[0],
            bounds_buf.ctypes.data_as(c.c_void_p), bounds_cap,
            n_out.ctypes.data_as(c.c_void_p))
        if rc != 0:
            return None  # capacity overflow: let the Python path handle it
        if n_out[0]:
            boundaries.append(bounds_buf[: int(n_out[0])].copy())
        if state[0] >= 3:  # done or fallback
            break
        sector += n
        if n < batch:
            break
    if state[0] < 3:
        lib.dvda_demux_finish(state.ctypes.data_as(c.c_void_p),
                              stream.ctypes.data_as(c.c_void_p))
    if state[0] == 4:  # malformed during probe: Python fallback
        return None
    out = (np.concatenate(boundaries) if boundaries
           else np.zeros(0, dtype=np.int64))
    return bytes(stream[: int(state[1])]), out, int(state[2])


def pcm_walk_capacity(aob, first_sector: int, total_frames: int,
                      csize: int) -> int:
    """Bytes :func:`walk_pcm_chunks` can write, a bound it never passes.
    Before the packet that ends the countdown the walk has written fewer
    than ``ceil(total_frames / 2)`` chunks (two frames a chunk); that
    packet, inside one sector, adds at most ``2048 // csize``.  Nor can it
    write more than the sectors from ``first_sector`` to the end of
    ``aob`` hold."""
    cap = ((max(int(total_frames), 0) + 1) // 2 + 2048 // csize) * csize
    sectors = max(int(aob.total_sectors) - int(first_sector), 0)
    return min(cap, sectors * 2048 // csize * csize)


def walk_pcm_chunks(aob, first_sector: int, parameters, total_frames: int,
                    csize: int, out: np.ndarray,
                    batch: int = 4096) -> int | None:
    """Native PCM packet walk (src/demux.cc:dvda_pcm_feed): every consumed
    packet's whole chunks, written once each, in order, into ``out`` (a
    writable C-contiguous uint8 array), honoring the PTS frame countdown
    and codec/parameter-match termination.  Semantics mirror
    api.py:TrackReader._decode_pcm.  Returns the bytes written, a
    multiple of ``csize``; the bytes past them are left as they were.
    ``None`` when the library is unavailable; raises where ``out`` is
    smaller than the walk needs (:func:`pcm_walk_capacity` always
    suffices)."""
    if not (out.dtype == np.uint8 and out.ndim == 1
            and out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("PCM walk: the destination must be a writable "
                         "C-contiguous 1-D uint8 array")
    lib = _load()
    if lib is None:
        return None
    c = ctypes
    b3 = (parameters.group_0_bps << 4) | parameters.group_1_bps
    b4 = (parameters.group_0_rate << 4) | parameters.group_1_rate
    b6 = parameters.channel_assignment
    state = np.zeros(4, dtype=np.int64)
    state[2] = total_frames
    sector = first_sector
    while not state[0]:
        sectors = aob.read_sectors(sector, batch)
        n = sectors.shape[0]
        if n == 0:
            break
        sectors = np.ascontiguousarray(sectors)
        # the feed appends at out + state[1] and checks the capacity
        rc = lib.dvda_pcm_feed(
            state.ctypes.data_as(c.c_void_p),
            sectors.ctypes.data_as(c.c_void_p), n, b3, b4, b6, csize,
            out.ctypes.data_as(c.c_void_p), out.shape[0])
        if rc != 0:
            raise RuntimeError(
                f"PCM walk: a packet past the destination's {out.shape[0]} "
                f"bytes (sector {sector}..{sector + n - 1})")
        sector += n
        if n < batch:
            break
    return int(state[1])


def assemble_pcm_chunks(aob, first_sector: int, parameters, total_frames: int,
                        csize: int, batch: int = 4096) -> bytes | None:
    """:func:`walk_pcm_chunks` into a buffer of its bound, as ``bytes``:
    the concatenated whole chunks of every consumed packet.  ``None`` when
    the library is unavailable."""
    out = np.empty(pcm_walk_capacity(aob, first_sector, total_frames, csize),
                   dtype=np.uint8)
    n = walk_pcm_chunks(aob, first_sector, parameters, total_frames, csize,
                        out, batch)
    return None if n is None else out[:n].tobytes()


def c2_decrypt_sectors(sectors: np.ndarray, media_key: int, album_id: int,
                       preserve_cci: bool) -> int | None:
    """Native in-place CPPM sector decryption (host/src/c2.cc); returns the
    number of encrypted sectors handled, or None if the library is
    unavailable.  ``sectors`` must be a contiguous uint8 [N, 2048]."""
    lib = _load()
    if lib is None:
        return None
    assert sectors.dtype == np.uint8 and sectors.flags.c_contiguous
    return int(lib.c2_decrypt_sectors(
        sectors.ctypes.data_as(ctypes.c_void_p), sectors.shape[0],
        media_key, album_id, 1 if preserve_cci else 0))

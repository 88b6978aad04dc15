"""The MLP general path's program — kernels K6a, K1, K6b and their plain
versions.

Port of dvda_tpu/codecs/mlp/native_engine.py::_pipeline (:502-556), which
dvda_tpu runs on streams its pipelined chunk driver abandons: geometry
churn, coupled-restart chains of unequal length, substreams whose geometry
disagrees.  Per substream the parse's blocks are packed into filter lanes
(one lane per restart chain × channel) by the chain table ``bidx``, the AR
filter runs (K1, :func:`~dvda_tpu_torch.ops.mlp_filter.
mlp_filter_blocks_tl`), and each output sample then gathers its channels,
runs its frame's matrix chain and the output stage:

  * :func:`lane_pack` (K6a, csrc/general_gather.cu): the lane pack, into
    K1's time-leading call layout;
  * :func:`series_remix` (K6b): series gather, rematrix
    (``rematrix_frames``, 6 slots), output shift and WAVE permutation, one
    row per sample — no frame-major intermediate;
  * :func:`general_pipeline`: K6a → K1 → K6b, int32 ``[T, C_out]``;
    :func:`general_pipeline_reference` composes the plain versions.

A substream's tables (:func:`substream_tables`) are the parse's own arrays
plus small index tables; ``series_idx`` points into K1's ``[NB, S, B]``
output (dvda_tpu's indexes its lane-major ``[B, NB, S]`` one).  On a CUDA
tensor each wrapper launches its kernel or raises; on a CPU tensor it runs
its plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.launch import check, current_stream, on_cuda, raise_on_error
from .mlp_filter import mlp_filter_blocks_tl, mlp_filter_blocks_tl_reference
from .rematrix import _wrap32

__all__ = ["lane_pack", "lane_pack_reference", "series_remix",
           "series_remix_reference", "general_pipeline",
           "general_pipeline_reference", "restart_chains",
           "substream_tables", "N_MATS"]

#: matrix slots the general path runs (rematrix_frames' default)
N_MATS = 6

_SUB_KEYS = ("res", "res_off", "lens", "bidx", "bmask", "rc_fir", "rc_iir",
             "iir_init", "shift", "quant", "iir_reset")


def restart_chains(sub: dict, nb_keep: int):
    """(chain_start, chain_len), int64, of one parsed substream's first
    ``nb_keep`` blocks: a chain starts at block 0 and at every restart
    whose first block uses no FIR taps; a coupled restart carries the
    filter state on (dvda_tpu's ``_decode_parsed``, :1440-1445)."""
    restarts = np.nonzero(sub["restart"][:nb_keep])[0]
    coupled = sub["fir_any"][restarts] != 0
    bounds = np.asarray([0] + [int(r) for i, r in enumerate(restarts)
                               if r != 0 and not coupled[i]] + [nb_keep],
                        dtype=np.int64)
    return bounds[:-1], np.diff(bounds)


def substream_tables(sub: dict, F: int, T: int) -> dict:
    """numpy tables of one parsed substream's first ``F`` frames for
    :func:`general_pipeline` (dvda_tpu's ``_decode_parsed``, :1434-1490,
    sized exactly instead of to powers of two), one filter lane per
    :func:`restart_chains` chain and channel.  Per-block arrays are views
    of the parse: keep it alive while the tables are used.  A substream
    with no blocks in the kept frames raises ValueError, as dvda_tpu's
    table build does (its series index, :1470)."""
    nb_keep = int(sub["fr_nblocks"][:F].sum())
    if nb_keep == 0:
        raise ValueError("substream has no blocks in the kept frames")
    lens = sub["len"][:nb_keep]
    n_ch = sub["shift"].shape[1]
    chain_start, chain_len = restart_chains(sub, nb_keep)
    n_chains = chain_start.shape[0]
    NB = int(chain_len.max())
    S = max(1, int(lens.max()))
    pos = np.arange(NB, dtype=np.int64)[None, :]
    bidx = np.minimum(chain_start[:, None] + pos, nb_keep - 1).astype(np.int32)
    bmask = pos < chain_len[:, None]
    cum = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])

    # series index: t -> K1's flat [NB, S, B] position of channel 0 (lane
    # chain*n_ch; channel c adds c); samples past the substream's blocks
    # read position 0, as dvda_tpu's zero-filled table does
    B = n_chains * n_ch
    chain_of_block = np.repeat(np.arange(n_chains), chain_len)
    pos_of_block = np.arange(nb_keep) - chain_start[chain_of_block]
    blk_of_t = np.repeat(np.arange(nb_keep), lens)
    off_in_blk = np.arange(int(cum[-1]), dtype=np.int64) - np.repeat(
        cum[:-1], lens)
    base = ((pos_of_block[blk_of_t] * S + off_in_blk) * B
            + chain_of_block[blk_of_t] * n_ch)
    series_idx = np.zeros(T, dtype=np.int64)
    n = min(T, base.shape[0])
    series_idx[:n] = base[:n]
    return dict(
        res=sub["residuals"][: int(cum[-1]) * n_ch], res_off=cum[:-1] * n_ch,
        lens=lens, bidx=bidx, bmask=bmask,
        rc_fir=sub["rc_fir"][:nb_keep], rc_iir=sub["rc_iir"][:nb_keep],
        iir_init=sub["iir_init"][:nb_keep], shift=sub["shift"][:nb_keep],
        quant=sub["quant"][:nb_keep], iir_reset=sub["iir_reset"][:nb_keep],
        series_idx=series_idx, S=S)


# ---------------------------------------------------------------- K6a

def _pack_shapes(u: dict):
    Bc, NB = u["bidx"].shape
    n_ch = u["shift"].shape[1]
    return Bc * n_ch, NB, int(u["S"]), n_ch


def lane_pack_reference(u: dict):
    """Plain PyTorch version of :func:`lane_pack`: index gathers."""
    B, NB, S, n_ch = _pack_shapes(u)
    dev = u["res"].device
    bidx = u["bidx"].long()
    lane_blk = bidx.repeat_interleave(n_ch, 0)               # [B, NB]
    lane_ch = torch.arange(n_ch, device=dev).repeat(B // n_ch)[:, None]
    src = lane_blk * n_ch + lane_ch                          # [B, NB]
    live = u["bmask"].repeat_interleave(n_ch, 0)
    lens = u["lens"].long()[lane_blk]                        # [B, NB]

    def rows(x):  # [NBt, n_ch, ...] -> [B, NB, ...]
        flat = x.reshape((-1,) + tuple(x.shape[2:]))
        return flat.index_select(0, src.reshape(-1)).reshape(
            (B, NB) + tuple(x.shape[2:]))

    s = torch.arange(S, device=dev)
    at = (u["res_off"][lane_blk][:, :, None]
          + lane_ch[:, :, None] * lens[:, :, None] + s)      # [B, NB, S]
    valid = s < lens[:, :, None]
    res = u["res"].take(torch.where(valid, at, 0))
    res_tl = torch.where(valid, res, 0).permute(1, 2, 0).contiguous()
    return (res_tl, rows(u["rc_fir"]), rows(u["rc_iir"]), rows(u["shift"]),
            rows(u["quant"]), rows(u["iir_reset"]) & live,
            rows(u["iir_init"]), torch.where(live, lens, 0).to(torch.int32),
            torch.zeros((B, 8), dtype=torch.int32, device=dev))


def _launch_pack(u):
    from ..kernels.build import kernel_library

    B, NB, S, n_ch = _pack_shapes(u)
    dev = u["res"].device
    i32 = torch.int32
    nbt = u["lens"].shape[0]
    check(u["res"], "res", i32, (u["res"].shape[0],), dev)
    check(u["res_off"], "res_off", torch.int64, (nbt,), dev)
    check(u["lens"], "lens", i32, (nbt,), dev)
    check(u["bidx"], "bidx", i32, (B // n_ch, NB), dev)
    check(u["bmask"], "bmask", torch.bool, (B // n_ch, NB), dev)
    for k in ("rc_fir", "rc_iir", "iir_init"):
        check(u[k], k, i32, (nbt, n_ch, 8), dev)
    for k in ("shift", "quant"):
        check(u[k], k, i32, (nbt, n_ch), dev)
    check(u["iir_reset"], "iir_reset", torch.bool, (nbt, n_ch), dev)
    if not 1 <= n_ch <= 8:
        raise ValueError(f"{n_ch} channels: the kernel takes 1..8")
    for k in ("rc_fir", "rc_iir", "iir_init"):  # read as 16-byte vectors
        if u[k].data_ptr() % 16:
            raise ValueError(f"{k}: not 16-byte aligned")
    outs = (torch.empty((NB, S, B), dtype=i32, device=dev),
            torch.empty((B, NB, 8), dtype=i32, device=dev),
            torch.empty((B, NB, 8), dtype=i32, device=dev),
            torch.empty((B, NB), dtype=i32, device=dev),
            torch.empty((B, NB), dtype=i32, device=dev),
            torch.empty((B, NB), dtype=torch.bool, device=dev),
            torch.empty((B, NB, 8), dtype=i32, device=dev),
            torch.empty((B, NB), dtype=i32, device=dev),
            torch.empty((B, 8), dtype=i32, device=dev))
    res_tl, fir, iir, shift, quant, reset, init, blen, state0 = outs
    lib = kernel_library()
    with torch.cuda.device(dev):
        rc = lib.dvda_lane_pack(
            *(u[k].data_ptr() for k in _SUB_KEYS), res_tl.data_ptr(),
            fir.data_ptr(), iir.data_ptr(), init.data_ptr(),
            shift.data_ptr(), quant.data_ptr(), reset.data_ptr(),
            blen.data_ptr(), state0.data_ptr(), B, NB, S, n_ch,
            current_stream(dev))
        lane_pack.launches += 1
    raise_on_error(rc, "lane_pack")
    return outs


def lane_pack(u: dict):
    """K1's inputs for one substream's tables (tensors of
    :func:`substream_tables`): ``(residuals_tl [NB, S, B], rc_fir, rc_iir,
    shift, quant, iir_reset, iir_init, block_len, state0)``, lane ``b*n_ch
    + c``.  Positions past a chain's length get ``block_len`` 0 and no IIR
    reset (the filter state freezes); ``state0`` is zeros."""
    if on_cuda(u["res"]):
        return _launch_pack(u)
    return lane_pack_reference(u)


#: kernel launches since the last reset (the CPU path never counts)
lane_pack.launches = 0


# ---------------------------------------------------------------- K6b

def series_remix_reference(outs, frame_start, noise01, bypassed, mat_coeff,
                           mat_noise, mat_out, mat_active, mat_quant,
                           out_shift, wave_perm):
    """Plain PyTorch version of :func:`series_remix`: ``take`` gathers and
    ``rematrix_frames`` + ``apply_output_stage`` (dvda_tpu/ops/rematrix.py
    :33-63, :113-121) per sample in int64."""
    T = noise01.shape[0]
    dev = noise01.device
    i64 = torch.int64
    cols = []
    for out, idx, n_ch in outs:
        flat = out.reshape(-1)
        cols += [flat.take(idx + c).to(i64) for c in range(n_ch)]
    cols += [torch.zeros(T, dtype=i64, device=dev)] * (8 - len(cols))
    ch = torch.stack(cols, 1)                                   # [T, 8]
    t = torch.arange(T, device=dev)
    f = torch.searchsorted(frame_start, t, right=True) - 1
    noise = noise01.to(i64)
    byp = bypassed.to(i64)
    cidx = torch.arange(8, device=dev)
    for m in range(N_MATS):
        acc = ((mat_coeff[:, m].to(i64)[f] * ch).sum(1)
               + (mat_noise[:, m].to(i64)[f] * noise).sum(1))
        shifted = _wrap32(acc >> 14)
        q = mat_quant[:, m].to(i64)[f]
        val = _wrap32(_wrap32((shifted >> q) << q) + ((byp >> m) & 1))
        sel = ((cidx == mat_out[:, m].to(i64)[f][:, None])
               & mat_active[:, m][f][:, None])
        ch = torch.where(sel, val[:, None], ch)
    staged = _wrap32(ch << out_shift.to(i64)[f])
    return staged[:, wave_perm.long()].to(torch.int32)


def _launch_remix(outs, frame_start, noise01, bypassed, mat_coeff, mat_noise,
                  mat_out, mat_active, mat_quant, out_shift, wave_perm):
    from ..kernels.build import kernel_library

    T = noise01.shape[0]
    F = frame_start.shape[0] - 1
    C_out = wave_perm.shape[0]
    dev = noise01.device
    i32 = torch.int32
    if not 1 <= len(outs) <= 2:
        raise ValueError(f"{len(outs)} substreams: the kernel takes 1 or 2")
    n_tot = sum(n for _, _, n in outs)
    if not (1 <= n_tot <= 8 and 1 <= C_out <= 8 and F >= 1):
        raise ValueError(f"channels {n_tot}/{C_out} or {F} frames outside "
                         "the kernel's range")
    for k, (out, idx, _) in enumerate(outs):
        check(out, f"out{k}", i32, tuple(out.shape), dev)
        check(idx, f"series_idx{k}", torch.int64, (T,), dev)
    check(frame_start, "frame_start", torch.int64, (F + 1,), dev)
    check(noise01, "noise01", i32, (T, 2), dev)
    check(bypassed, "bypassed", torch.uint8, (T,), dev)
    check(mat_coeff, "mat_coeff", i32, (F, 6, 8), dev)
    check(mat_noise, "mat_noise", i32, (F, 6, 2), dev)
    check(mat_out, "mat_out", i32, (F, 6), dev)
    check(mat_active, "mat_active", torch.bool, (F, 6), dev)
    check(mat_quant, "mat_quant", i32, (F, 6), dev)
    check(out_shift, "out_shift", i32, (F, 8), dev)
    check(wave_perm, "wave_perm", i32, (C_out,), dev)
    y = torch.empty((T, C_out), dtype=i32, device=dev)
    (o0, i0, n0), (o1, i1, n1) = (outs + [(outs[0][0], outs[0][1], 0)])[:2]
    lib = kernel_library()
    with torch.cuda.device(dev):
        rc = lib.dvda_series_remix(
            o0.data_ptr(), i0.data_ptr(), n0, o1.data_ptr(), i1.data_ptr(),
            n1, frame_start.data_ptr(), noise01.data_ptr(),
            bypassed.data_ptr(), mat_coeff.data_ptr(), mat_noise.data_ptr(),
            mat_out.data_ptr(), mat_active.data_ptr(), mat_quant.data_ptr(),
            out_shift.data_ptr(), wave_perm.data_ptr(), y.data_ptr(), T, F,
            C_out, current_stream(dev))
        series_remix.launches += 1
    raise_on_error(rc, "series_remix")
    return y


def series_remix(
    outs,          # per substream: (K1 out int32 [NB, S, B], series_idx
                   # int64 [T], n_ch); channels concatenate in order
    frame_start,   # int64 [F+1]  first sample of each frame, then T
    noise01,       # int32 [T, 2] noise channels (already << noise shift)
    bypassed,      # uint8 [T]    bit m: bypassed LSB of matrix slot m
    mat_coeff,     # int32 [F, 6, 8]
    mat_noise,     # int32 [F, 6, 2]
    mat_out,       # int32 [F, 6]
    mat_active,    # bool  [F, 6]
    mat_quant,     # int32 [F, 6]
    out_shift,     # int32 [F, 8]
    wave_perm,     # int32 [C_out]  WAVE slot k comes from channel perm[k]
):
    """The general path's output half: int32 ``[T, C_out]`` in WAVE
    order.  CUDA tensors go through kernel K6b."""
    args = (list(outs), frame_start, noise01, bypassed, mat_coeff, mat_noise,
            mat_out, mat_active, mat_quant, out_shift, wave_perm)
    if on_cuda(noise01):
        return _launch_remix(*args)
    return series_remix_reference(*args)


#: kernel launches since the last reset (the CPU path never counts)
series_remix.launches = 0


# ------------------------------------------------------------ composition

def _compose(subs, frames, pack, filt, remix):
    outs = []
    for u in subs:
        (res_tl, rc_fir, rc_iir, shift, quant, iir_reset, iir_init,
         block_len, state0) = pack(u)
        out = filt(res_tl, rc_fir, rc_iir, shift, quant, iir_reset,
                   iir_init, block_len, state0, state0)[0]
        outs.append((out, u["series_idx"], u["shift"].shape[1]))
    return remix(outs, *frames)


def general_pipeline(subs, frames):
    """``subs``: per substream, :func:`substream_tables` as tensors on one
    device; ``frames``: the positional frame arguments of
    :func:`series_remix` after ``outs``.  K6a → K1 → K6b per the tensors'
    device; returns int32 ``[T, C_out]``."""
    return _compose(subs, frames, lane_pack, mlp_filter_blocks_tl,
                    series_remix)


def general_pipeline_reference(subs, frames):
    """:func:`general_pipeline` through the plain versions only."""
    return _compose(subs, frames, lane_pack_reference,
                    mlp_filter_blocks_tl_reference, series_remix_reference)

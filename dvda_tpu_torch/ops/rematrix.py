"""The rematrix and output stage — kernels K234 and K9, with their plain
versions.

K234 (:func:`output_stage`) is the chunk program's output half.  One pass
over the AR filter's output computes what the JAX chunk program
(dvda_tpu/codecs/mlp/native_engine.py::_uniform_arena_pipeline) does in
five stages:

  * LFSR noise from per-frame seeds (:282-301; mlp.c:1327-1335);
  * the bypassed-LSB unpack (:303-311);
  * the rematrix, dvda_tpu/ops/rematrix.py::rematrix_frames_tl
    (mlp.c:1308-1358): per frame up to 6 matrices apply in order, each an
    int64 dot over 8 channels plus 2 noise channels, ``>> 14`` cut to int32,
    the quant mask, ``+`` the bypassed bit, written into ``mat_out``;
  * the output shift and WAVE permutation, ``apply_output_stage_tl``
    (mlp.c:514-533);
  * the little-endian byte pack into WAV time order (:319-328, :370-372).

With ``tier`` 12 or 16 the same call is K234n, the narrow readback of a
24-bit chunk (:330-369): the 16-bit tier (int16 little-endian) or the
12-bit tier (channel pairs in 3 bytes), then 8 rows whose every byte is
the chunk's fits flag.  Its launches count apart, in
``output_stage.narrow_launches``.

Its inputs are the chunk's arena arrays as the arena builder lays them out
(frame arrays chain-major, narrow dtypes); see :func:`output_stage`.

K9 (:func:`frame_remix`) is the frame-major form of the same chain:
dvda_tpu/ops/rematrix.py::rematrix_frames (:33-63) then
``apply_output_stage`` (:113-121), in their layouts (``[F, L, C]`` int32,
int32 ``bypassed [F, 6, L]`` added as a full value, not a bit).  The fused
decode step (parallel/step.py) and the batched engine
(codecs/mlp/engine.py) run it after K1.  :func:`rematrix_frames` and
:func:`apply_output_stage` keep dvda_tpu's signatures and go through K9
with a neutral other half.

On a CUDA tensor each wrapper launches its kernel (csrc/output_stage.cu,
csrc/frame_remix.cu) or raises; on a CPU tensor it runs the plain version
(:func:`output_stage_reference`; :func:`rematrix_frames_reference` and
:func:`apply_output_stage_reference`).
"""

from __future__ import annotations

import torch

from ..kernels.launch import check, current_stream, on_cuda, raise_on_error

__all__ = ["output_stage", "output_stage_reference", "narrow_pack",
           "frame_remix",
           "rematrix_frames", "rematrix_frames_reference",
           "apply_output_stage", "apply_output_stage_reference",
           "MAX_MATRICES"]

MAX_MATRICES = 6


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value C's truncating cast gives, kept in int64."""
    return x.to(torch.int32).to(torch.int64)


def _geometry(series, mat_coeff, wave_perm, chains):
    """(Bc, fpc, L0, C_tot, C_out) from the shapes, validated."""
    Bc = int(chains)
    F_pad = mat_coeff.shape[0]
    if Bc <= 0 or F_pad % Bc:
        raise ValueError(f"{F_pad} frames do not split into {Bc} chains")
    fpc = F_pad // Bc
    period = series.shape[0]
    if fpc == 0 or period % fpc:
        raise ValueError(f"period {period} is not a multiple of {fpc} "
                         "frames per chain")
    if series.dim() != 2 or series.shape[1] % Bc:
        raise ValueError(f"series shape {tuple(series.shape)} does not "
                         f"hold {Bc} chains")
    C_tot = series.shape[1] // Bc
    C_out = wave_perm.shape[0]
    if not (1 <= C_tot <= 8 and 1 <= C_out <= 8):
        raise ValueError(f"channel counts {C_tot}/{C_out} outside 1..8")
    return Bc, fpc, period // fpc, C_tot, C_out


def narrow_pack(rows: torch.Tensor, tier: int) -> torch.Tensor:
    """The narrow readback of staged samples ``rows`` (int64 ``[T, C_out]``
    holding int32 values), as dvda_tpu's chunk program computes it
    (native_engine.py:346-369): the fits flags from the minimum and
    maximum over every row, the 16-bit tier's low two bytes of each value or
    the 12-bit tier's channel pairs in 3 bytes, then 8 rows of the flag.
    Returns uint8 ``[T + 8, C_out*2]`` (tier 16) or ``[T + 8, C_out/2*3]``
    (tier 12)."""
    lo, hi = rows.min(), rows.max()
    fits16 = int(bool(lo >= -(1 << 15)) and bool(hi < (1 << 15)))
    if tier == 12:
        fits12 = int(bool(lo >= -(1 << 11)) and bool(hi < (1 << 11)))
        c0, c1 = rows[:, 0::2], rows[:, 1::2]
        pk = torch.stack([c0 & 0xFF, ((c0 >> 8) & 0xF) | ((c1 & 0xF) << 4),
                          (c1 >> 4) & 0xFF], 2)
        flag = fits12 + 2 * fits16
    else:
        pk = torch.stack([rows & 0xFF, (rows >> 8) & 0xFF], 2)
        flag = fits16
    narrow = pk.to(torch.uint8).reshape(rows.shape[0], -1)
    return torch.cat([narrow, torch.full((8, narrow.shape[1]), flag,
                                         dtype=torch.uint8,
                                         device=rows.device)])


def _check_form(nbytes: int, tier: int, C_out: int) -> None:
    if nbytes not in (0, 2, 3):
        raise ValueError(f"nbytes must be 0, 2 or 3, got {nbytes}")
    if tier not in (0, 12, 16):
        raise ValueError(f"tier must be 0, 12 or 16, got {tier}")
    if tier and nbytes != 3:
        raise ValueError("the narrow tiers read back 24-bit chunks "
                         f"(nbytes 3), got nbytes {nbytes}")
    if tier == 12 and C_out % 2:
        raise ValueError(f"the 12-bit tier packs channel pairs: C_out "
                         f"{C_out} is odd")


def output_stage_reference(series, frame_seed, frame_nshift, byp, mat_coeff,
                           mat_noise, mat_out, mat_active, mat_quant,
                           out_shift, wave_perm, *, chains: int, n_mats: int,
                           nbytes: int, tier: int = 0):
    """Plain PyTorch version of :func:`output_stage`: vectorised int64 ops
    over frames, samples and chains, the matrices in a loop and the LFSR
    stepped serially over the frame's samples; with ``tier``,
    :func:`narrow_pack` of the staged samples."""
    _check_form(nbytes, tier, wave_perm.shape[0])
    Bc, fpc, L0, C_tot, C_out = _geometry(series, mat_coeff, wave_perm,
                                          chains)
    period = fpc * L0
    i64 = torch.int64
    dev = series.device

    def tlf(x):  # chain-major [Bc*fpc, ...] → [fpc, ..., Bc]
        return x.reshape((Bc, fpc) + tuple(x.shape[1:])).movedim(0, -1) \
            .to(i64)

    ch = series.reshape(fpc, L0, C_tot, Bc).to(i64)
    if C_tot < 8:
        ch = torch.cat([ch, torch.zeros((fpc, L0, 8 - C_tot, Bc), dtype=i64,
                                        device=dev)], 2)
    # noise: int8(seed >> 15) and int8(seed >> 7), << nshift, per sample
    seed = tlf(frame_seed) & 0xFFFFFFFF                      # [fpc, Bc]
    nshift = tlf(frame_nshift)
    n0s, n1s = [], []
    for _ in range(L0):
        b0 = (seed >> 15) & 0xFF
        b1 = (seed >> 7) & 0xFF
        n0s.append(_wrap32(((b0 ^ 0x80) - 0x80) << nshift))
        n1s.append(_wrap32(((b1 ^ 0x80) - 0x80) << nshift))
        sh = (seed >> 7) & 0xFFFF
        seed = ((seed << 16) ^ sh ^ (sh << 5)) & 0xFFFFFFFF
    noise = torch.stack([torch.stack(n0s, 1), torch.stack(n1s, 1)], 2)
    bits = byp.reshape(Bc, period).t().reshape(fpc, L0, Bc).to(i64)
    coeff = tlf(mat_coeff)                                   # [fpc, 6, 8, Bc]
    ncoef = tlf(mat_noise)                                   # [fpc, 6, 2, Bc]
    mout = tlf(mat_out)                                      # [fpc, 6, Bc]
    mact = tlf(mat_active) != 0
    mquant = tlf(mat_quant)
    cidx = torch.arange(8, device=dev)[None, None, :, None]
    for m in range(n_mats):
        acc = ((coeff[:, m, None] * ch).sum(2)
               + (ncoef[:, m, None] * noise).sum(2))         # [fpc, L0, Bc]
        shifted = _wrap32(acc >> 14)
        q = mquant[:, m, None]
        val = _wrap32(_wrap32((shifted >> q) << q) + ((bits >> m) & 1))
        sel = (cidx == mout[:, m, None, None]) & mact[:, m, None, None]
        ch = torch.where(sel, val[:, :, None], ch)
    staged = _wrap32(ch << tlf(out_shift)[:, None])          # [fpc,L0,8,Bc]
    staged = staged[:, :, wave_perm.long()]                  # [fpc,L0,C_out,Bc]
    rows = staged.permute(3, 0, 1, 2).reshape(Bc * period, C_out)
    if tier:
        return narrow_pack(rows, tier)
    if nbytes == 0:
        return rows.to(torch.int32)
    pk = torch.stack([(rows >> (8 * k)) & 0xFF for k in range(nbytes)], 2)
    return pk.to(torch.uint8).reshape(Bc * period, C_out * nbytes)


#: K234n's scratch per (device, stream): two words, the kernel's 64-bit
#: counter of blocks and misfit bits.  Zeroed once when made; each launch
#: leaves it zero, and launches on one stream run in order.
_SCRATCH: dict = {}


def _narrow_scratch(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _SCRATCH[key]


def _launch(series, frame_seed, frame_nshift, byp, mat_coeff, mat_noise,
            mat_out, mat_active, mat_quant, out_shift, wave_perm, chains,
            n_mats, nbytes, tier):
    from ..kernels.build import kernel_library

    Bc, fpc, L0, C_tot, C_out = _geometry(series, mat_coeff, wave_perm,
                                          chains)
    F_pad, period = Bc * fpc, fpc * L0
    dev = series.device
    i8 = torch.int8
    check(series, "series", torch.int32, (period, C_tot * Bc), dev)
    check(frame_seed, "frame_seed", torch.int32, (F_pad,), dev)
    check(frame_nshift, "frame_nshift", i8, (F_pad,), dev)
    check(byp, "byp", i8, (Bc * period,), dev)
    check(mat_coeff, "mat_coeff", torch.int16, (F_pad, 6, 8), dev)
    check(mat_noise, "mat_noise", torch.int16, (F_pad, 6, 2), dev)
    for name, t in (("mat_out", mat_out), ("mat_active", mat_active),
                    ("mat_quant", mat_quant)):
        check(t, name, i8, (F_pad, 6), dev)
    check(out_shift, "out_shift", i8, (F_pad, 8), dev)
    check(wave_perm, "wave_perm", i8, (C_out,), dev)
    if tier:
        row = C_out * 2 if tier == 16 else C_out // 2 * 3
        out = torch.empty((Bc * period + 8, row), dtype=torch.uint8,
                          device=dev)
    elif nbytes:
        out = torch.empty((Bc * period, C_out * nbytes), dtype=torch.uint8,
                          device=dev)
    else:
        out = torch.empty((Bc * period, C_out), dtype=torch.int32,
                          device=dev)
    lib = kernel_library()
    ptrs = (series.data_ptr(), frame_seed.data_ptr(), frame_nshift.data_ptr(),
            byp.data_ptr(), mat_coeff.data_ptr(), mat_noise.data_ptr(),
            mat_out.data_ptr(), mat_active.data_ptr(), mat_quant.data_ptr(),
            out_shift.data_ptr(), wave_perm.data_ptr(), out.data_ptr())
    if tier:
        with torch.cuda.device(dev):
            stream = current_stream(dev)
            rc = lib.dvda_output_stage_narrow(
                *ptrs, _narrow_scratch(dev, stream).data_ptr(), Bc, fpc, L0,
                C_tot, C_out, n_mats, tier, stream)
            output_stage.narrow_launches += 1
        raise_on_error(rc, "output_stage_narrow")
        return out
    with torch.cuda.device(dev):
        rc = lib.dvda_output_stage(
            series.data_ptr(), frame_seed.data_ptr(), frame_nshift.data_ptr(),
            byp.data_ptr(), mat_coeff.data_ptr(), mat_noise.data_ptr(),
            mat_out.data_ptr(), mat_active.data_ptr(), mat_quant.data_ptr(),
            out_shift.data_ptr(), wave_perm.data_ptr(), out.data_ptr(),
            Bc, fpc, L0, C_tot, C_out, n_mats, nbytes, current_stream(dev))
        output_stage.launches += 1
    raise_on_error(rc, "output_stage")
    return out


def output_stage(
    series,        # int32 [period, C_tot*Bc]  filter output, chains minor
    frame_seed,    # int32 [Bc*fpc]  uint32 LFSR seed bits, chain-major
    frame_nshift,  # int8  [Bc*fpc]
    byp,           # int8  [Bc*period]  bit m: bypassed LSB of slot m
    mat_coeff,     # int16 [Bc*fpc, 6, 8]
    mat_noise,     # int16 [Bc*fpc, 6, 2]
    mat_out,       # int8  [Bc*fpc, 6]
    mat_active,    # int8  [Bc*fpc, 6]
    mat_quant,     # int8  [Bc*fpc, 6]
    out_shift,     # int8  [Bc*fpc, 8]
    wave_perm,     # int8  [C_out]  WAVE slot k comes from channel perm[k]
    *,
    chains: int,   # Bc: restart chains in the chunk
    n_mats: int,   # matrix slots to run (highest active slot + 1)
    nbytes: int,   # 3 / 2: packed LE bytes; 0: int32 samples
    tier: int = 0,  # 12 / 16: K234n's narrow readback (nbytes 3); 0: off
):
    """Noise, bypass unpack, rematrix, output shift, WAVE permutation and
    byte pack in one pass.  Returns uint8 ``[Bc*period, C_out*nbytes]``
    (``nbytes`` 2 or 3) or int32 ``[Bc*period, C_out]`` (``nbytes`` 0),
    row ``b*period + t`` holding chain ``b``'s in-chain sample ``t``; with
    ``tier``, the narrow rows and 8 flag rows of :func:`narrow_pack`."""
    _check_form(nbytes, tier, wave_perm.shape[0])
    if not 0 <= n_mats <= MAX_MATRICES:
        raise ValueError(f"n_mats must be in 0..{MAX_MATRICES}, got {n_mats}")
    args = (series, frame_seed, frame_nshift, byp, mat_coeff, mat_noise,
            mat_out, mat_active, mat_quant, out_shift, wave_perm)
    if on_cuda(series):
        return _launch(*args, chains, n_mats, nbytes, tier)
    return output_stage_reference(*args, chains=chains, n_mats=n_mats,
                                  nbytes=nbytes, tier=tier)


#: kernel launches since the last reset (the CPU path never counts): K234,
#: and apart from it K234n (``tier`` 12 or 16)
output_stage.launches = 0
output_stage.narrow_launches = 0


# ------------------------------------------------------- K9: frame-major


def _xla_shift_ok(s: torch.Tensor):
    """(in range, clamped): XLA's shifts by an amount outside [0, 32) give
    0 for ``<<`` and for the quant mask's ``(x >> q) << q``."""
    return (s >= 0) & (s < 32), s.clamp(0, 31)


def rematrix_frames_reference(channels, noise, mat_coeff, mat_noise, mat_out,
                              mat_active, mat_quant, bypassed,
                              n_mats: int = MAX_MATRICES):
    """Plain PyTorch version of :func:`rematrix_frames`: int64 tensor ops
    over frames and samples, the matrices in a loop; any channel count."""
    if not 0 <= n_mats <= MAX_MATRICES:
        raise ValueError(f"n_mats must be in 0..{MAX_MATRICES}, got {n_mats}")
    i64 = torch.int64
    ch = channels.to(i64)                                    # [F, L, C]
    nz = noise.to(i64)                                       # [F, L, 2]
    cidx = torch.arange(ch.shape[2], device=ch.device)
    for m in range(n_mats):
        acc = ((mat_coeff[:, m, None, :].to(i64) * ch).sum(2)
               + (mat_noise[:, m, None, :].to(i64) * nz).sum(2))  # [F, L]
        shifted = _wrap32(acc >> 14)
        ok, q = _xla_shift_ok(mat_quant[:, m, None].to(i64))
        masked = torch.where(ok, (shifted >> q) << q, 0)
        val = _wrap32(masked + bypassed[:, m].to(i64))
        sel = ((cidx == mat_out[:, m, None, None].to(i64))
               & mat_active[:, m, None, None].bool())
        ch = torch.where(sel, val[:, :, None], ch)
    return ch.to(torch.int32)


def apply_output_stage_reference(channels, output_shift, wave_perm):
    """Plain PyTorch version of :func:`apply_output_stage`."""
    ok, s = _xla_shift_ok(output_shift.to(torch.int64)[:, None, :])
    shifted = torch.where(ok, _wrap32(channels.to(torch.int64) << s), 0)
    perm = torch.as_tensor(wave_perm, device=channels.device).long()
    return shifted.index_select(2, perm).to(torch.int32)


def _perm_list(wave_perm, C: int) -> list[int]:
    """``wave_perm``'s values, read on the host (a CUDA tensor costs one
    small copy), each checked to name one of the C channels."""
    perm = [int(v) for v in torch.as_tensor(wave_perm).reshape(-1).tolist()]
    bad = [v for v in perm if not 0 <= v < C]
    if bad:
        raise ValueError(f"wave_perm values {bad} outside [0, {C})")
    return perm


def _launch_remix(channels, noise, mat_coeff, mat_noise, mat_out, mat_active,
                  mat_quant, bypassed, output_shift, perm, n_mats):
    from ..kernels.build import kernel_library

    F, L, C = channels.shape
    C_out = len(perm)
    if not (1 <= C <= 8 and 1 <= C_out <= 8):
        raise ValueError(f"K9 takes 1..8 channels in and out, got {C} and "
                         f"{C_out}")
    bits = sum(v << (4 * k) for k, v in enumerate(perm))  # 4 bits a slot
    dev = channels.device
    i32 = torch.int32
    check(channels, "channels", i32, (F, L, C), dev)
    check(noise, "noise", i32, (F, L, 2), dev)
    check(mat_coeff, "mat_coeff", i32, (F, 6, C), dev)
    check(mat_noise, "mat_noise", i32, (F, 6, 2), dev)
    check(mat_out, "mat_out", i32, (F, 6), dev)
    check(mat_active, "mat_active", torch.bool, (F, 6), dev)
    check(mat_quant, "mat_quant", i32, (F, 6), dev)
    check(bypassed, "bypassed", i32, (F, 6, L), dev)
    check(output_shift, "output_shift", i32, (F, C), dev)
    out = torch.empty((F, L, C_out), dtype=i32, device=dev)
    lib = kernel_library()
    with torch.cuda.device(dev):
        rc = lib.dvda_frame_remix(
            channels.data_ptr(), noise.data_ptr(), mat_coeff.data_ptr(),
            mat_noise.data_ptr(), mat_out.data_ptr(), mat_active.data_ptr(),
            mat_quant.data_ptr(), bypassed.data_ptr(),
            output_shift.data_ptr(), out.data_ptr(), F, L, C, C_out, n_mats,
            bits, current_stream(dev))
        frame_remix.launches += 1
    raise_on_error(rc, "frame_remix")
    return out


def frame_remix(
    channels,      # int32 [F, L, C]
    noise,         # int32 [F, L, 2]  (already << noise_shift)
    mat_coeff,     # int32 [F, 6, C]  channel coefficients (0 beyond mmc)
    mat_noise,     # int32 [F, 6, 2]  noise-channel coefficients
    mat_out,       # int32 [F, 6]     output channel index
    mat_active,    # bool  [F, 6]
    mat_quant,     # int32 [F, 6]     quant_step_size[out_channel]
    bypassed,      # int32 [F, 6, L]
    output_shift,  # int32 [F, C]
    wave_perm,     # int [C_out], any device: WAVE slot k ← channel perm[k]
    n_mats: int = MAX_MATRICES,  # slots to run (highest active slot + 1)
):
    """``apply_output_stage(rematrix_frames(...), output_shift, wave_perm)``
    in one pass; returns int32 ``[F, L, C_out]``.  ``wave_perm`` values
    outside ``[0, C)`` raise.  On a CUDA ``channels`` the wrapper launches
    K9 (C and C_out at most 8, else it raises); on the CPU it runs the
    plain versions, which take any C."""
    if not 0 <= n_mats <= MAX_MATRICES:
        raise ValueError(f"n_mats must be in 0..{MAX_MATRICES}, got {n_mats}")
    if channels.dim() != 3:
        raise ValueError(f"channels shape {tuple(channels.shape)}, expected "
                         "[F, L, C]")
    perm = _perm_list(wave_perm, channels.shape[2])
    if on_cuda(channels):
        return _launch_remix(channels, noise, mat_coeff, mat_noise, mat_out,
                             mat_active, mat_quant, bypassed, output_shift,
                             perm, n_mats)
    return apply_output_stage_reference(
        rematrix_frames_reference(channels, noise, mat_coeff, mat_noise,
                                  mat_out, mat_active, mat_quant, bypassed,
                                  n_mats), output_shift, perm)


#: kernel launches since the last reset (the CPU path never counts)
frame_remix.launches = 0


def rematrix_frames(channels, noise, mat_coeff, mat_noise, mat_out,
                    mat_active, mat_quant, bypassed,
                    n_mats: int = MAX_MATRICES):
    """dvda_tpu's ``rematrix_frames``: the per-frame matrix chain; returns
    the updated int32 ``[F, L, C]`` channels.  K9 with a zero output shift
    and the identity permutation."""
    F, _, C = channels.shape
    return frame_remix(channels, noise, mat_coeff, mat_noise, mat_out,
                       mat_active, mat_quant, bypassed,
                       channels.new_zeros((F, C)), list(range(C)), n_mats)


def apply_output_stage(channels, output_shift, wave_perm):
    """dvda_tpu's ``apply_output_stage``: output shifts then the RIFF WAVE
    permutation (mlp.c:514-533); returns int32 ``[F, L, C_out]``.  K9 with
    no matrix slot."""
    F, L, C = channels.shape
    z = channels.new_zeros
    return frame_remix(channels, z((F, L, 2)), z((F, 6, C)), z((F, 6, 2)),
                       z((F, 6)), z((F, 6), dtype=torch.bool), z((F, 6)),
                       z((F, 6, L)), output_shift, wave_perm, n_mats=0)

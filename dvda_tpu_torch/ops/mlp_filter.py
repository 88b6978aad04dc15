"""Batched MLP AR reconstruction filter — kernel K1 and its plain version.

Port of dvda_tpu/ops/mlp_filter.py (and of the Pallas kernel in
dvda_tpu/ops/pallas_filter.py, which computes the same function).  The
public signatures and layouts are the JAX package's:

  * :func:`mlp_filter_blocks_tl` — time-leading residuals and output
    ``[NB, S, B]`` (lanes minor), explicit initial states, returns
    ``(out, fir_state, iir_state)``; the general path calls this one;
  * :func:`mlp_filter_blocks` — lane-leading ``[B, NB, S]``;
  * :func:`mlp_filter_frames` — the fused decode step's filter half
    (dvda_tpu/parallel/step.py:63-72): ``[F, C, NB, S]`` lanes, zero
    states, the frame-major channels ``[F, NB*S, C]`` out.

A lane is one (restart chain × channel) pair.  Per sample: an 8-tap FIR
over previous outputs plus an 8-tap IIR over previous errors, accumulated
exactly in int64, then ``(int32)(acc >> shift)``, the residual add and the
quant mask ``(x >> q) << q`` (mlp.c:1243-1306).  IIR state is replaced at
``iir_reset`` blocks; state is frozen at samples ``>= block_len``.  An
initial state of ``None`` is zero: dvda_tpu's callers always pass zeros
there.

On a CUDA tensor each entry launches the hand-written kernel
(csrc/mlp_filter.cu) once, on its own layout: the kernel stages
lane-leading rows in place and writes each layout itself, so no entry
copies on the card; else it raises.  On a CPU tensor it runs
:func:`mlp_filter_blocks_tl_reference`, behind permutes for the other
layouts.
"""

from __future__ import annotations

import torch

from ..kernels.launch import check, current_stream, on_cuda, raise_on_error

__all__ = ["mlp_filter_blocks", "mlp_filter_blocks_tl", "mlp_filter_frames",
           "mlp_filter_blocks_tl_reference"]

#: dvda_mlp_filter's layouts: time-leading in and out; lane-leading in and
#: the frame-major ``[B / C, NB*S, C]`` out (lane-leading at C = 1)
_TIME_LEADING, _LANE_IN = 0, 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value C's truncating cast gives, kept in int64."""
    return x.to(torch.int32).to(torch.int64)


def mlp_filter_blocks_tl_reference(residuals_tl, rc_fir, rc_iir, shift,
                                   quant, iir_reset, iir_init, block_len,
                                   fir_state0, iir_state0):
    """Plain PyTorch version: a Python loop over blocks and samples with
    int64 tensor ops across the lanes.  Same arguments and results as
    :func:`mlp_filter_blocks_tl` (a ``None`` initial state is zero)."""
    NB, S, B = residuals_tl.shape
    i64 = torch.int64
    zero = torch.zeros((B, 8), dtype=i64, device=residuals_tl.device)
    fs = zero if fir_state0 is None else fir_state0.to(i64)  # 7 = newest
    is_ = zero if iir_state0 is None else iir_state0.to(i64)
    out = torch.empty((NB, S, B), dtype=torch.int32,
                      device=residuals_tl.device)
    for nb in range(NB):
        fc = rc_fir[:, nb].to(i64)
        ic = rc_iir[:, nb].to(i64)
        is_ = torch.where(iir_reset[:, nb, None], iir_init[:, nb].to(i64),
                          is_)
        sh = shift[:, nb].to(i64)
        q = quant[:, nb].to(i64)
        blen = block_len[:, nb]
        for i in range(S):
            acc = (fc * fs).sum(1) + (ic * is_).sum(1)
            shifted = _wrap32(acc >> sh)
            x = _wrap32(shifted + residuals_tl[nb, i].to(i64))
            value = _wrap32((x >> q) << q)
            out[nb, i] = value.to(torch.int32)
            valid = (blen > i)[:, None]
            fs = torch.where(valid, torch.cat([fs[:, 1:], value[:, None]], 1),
                             fs)
            err = _wrap32(value - shifted)
            is_ = torch.where(valid, torch.cat([is_[:, 1:], err[:, None]], 1),
                              is_)
    return out, fs.to(torch.int32), is_.to(torch.int32)


def _launch(res, rc_fir, rc_iir, shift, quant, iir_reset, iir_init,
            block_len, fir_state0, iir_state0, layout, C=1,
            final_states=True):
    """K1 once in ``layout``; returns (out, fir_state, iir_state), the
    states None unless ``final_states``."""
    from ..kernels.build import kernel_library

    if layout == _TIME_LEADING:
        NB, S, B = res.shape
        out_shape = (NB, S, B)
    else:
        B, NB, S = res.shape
        out_shape = (B // C, NB * S, C)
    dev = res.device
    i32 = torch.int32
    check(res, "residuals", i32, tuple(res.shape), dev)
    for name, t in (("rc_fir", rc_fir), ("rc_iir", rc_iir),
                    ("iir_init", iir_init)):
        check(t, name, i32, (B, NB, 8), dev)
    for name, t in (("shift", shift), ("quant", quant),
                    ("block_len", block_len)):
        check(t, name, i32, (B, NB), dev)
    check(iir_reset, "iir_reset", torch.bool, (B, NB), dev)
    for name, t in (("fir_state0", fir_state0), ("iir_state0", iir_state0)):
        if t is not None:
            check(t, name, i32, (B, 8), dev)
    out = torch.empty(out_shape, dtype=i32, device=dev)
    fir_state = iir_state = None
    if final_states:
        fir_state = torch.empty((B, 8), dtype=i32, device=dev)
        iir_state = torch.empty((B, 8), dtype=i32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = kernel_library()
    with torch.cuda.device(dev):
        rc = lib.dvda_mlp_filter(
            res.data_ptr(), rc_fir.data_ptr(), rc_iir.data_ptr(),
            shift.data_ptr(), quant.data_ptr(), iir_reset.data_ptr(),
            iir_init.data_ptr(), block_len.data_ptr(), ptr(fir_state0),
            ptr(iir_state0), out.data_ptr(), ptr(fir_state),
            ptr(iir_state), B, NB, S, layout, C, current_stream(dev))
        mlp_filter_blocks_tl.launches += 1
    raise_on_error(rc, "mlp_filter")
    return out, fir_state, iir_state


def mlp_filter_blocks_tl(
    residuals_tl,  # int32 [NB, S, B]  time-leading (lanes minor)
    rc_fir,        # int32 [B, NB, 8]  reversed taps (index 7 ↔ most recent)
    rc_iir,        # int32 [B, NB, 8]
    shift,         # int32 [B, NB]
    quant,         # int32 [B, NB]
    iir_reset,     # bool  [B, NB]
    iir_init,      # int32 [B, NB, 8]
    block_len,     # int32 [B, NB]
    fir_state0,    # int32 [B, 8]
    iir_state0,    # int32 [B, 8]
):
    """Run the filter; returns (out [NB, S, B], fir_state [B, 8],
    iir_state [B, 8]).  CUDA tensors go through kernel K1."""
    args = (residuals_tl, rc_fir, rc_iir, shift, quant, iir_reset, iir_init,
            block_len, fir_state0, iir_state0)
    if on_cuda(residuals_tl):
        return _launch(*args, _TIME_LEADING)
    return mlp_filter_blocks_tl_reference(*args)


#: kernel launches since the last reset, every entry's (the CPU path never
#: counts)
mlp_filter_blocks_tl.launches = 0


def mlp_filter_blocks(
    residuals,          # int32 [B, NB, S]
    rc_fir,             # int32 [B, NB, 8]
    rc_iir,             # int32 [B, NB, 8]
    shift,              # int32 [B, NB]
    quant,              # int32 [B, NB]
    iir_reset,          # bool  [B, NB]
    iir_init,           # int32 [B, NB, 8]
    block_len,          # int32 [B, NB]
    fir_state0=None,    # int32 [B, 8], or None: zero
    iir_state0=None,    # int32 [B, 8], or None: zero
):
    """Lane-leading entry; returns (out [B, NB, S], fir_state, iir_state).
    CUDA tensors go through one K1 launch on the lane-leading rows."""
    args = (rc_fir, rc_iir, shift, quant, iir_reset, iir_init, block_len,
            fir_state0, iir_state0)
    if on_cuda(residuals):
        out, fir_f, iir_f = _launch(residuals, *args, _LANE_IN)
        return out.view(residuals.shape), fir_f, iir_f
    out, fir_f, iir_f = mlp_filter_blocks_tl_reference(
        residuals.permute(1, 2, 0), *args)
    return out.permute(2, 0, 1).contiguous(), fir_f, iir_f


def mlp_filter_frames(
    residuals,   # int32 [F, C, NB, S]
    rc_fir,      # int32 [F, C, NB, 8]
    rc_iir,      # int32 [F, C, NB, 8]
    shift,       # int32 [F, C, NB]
    quant,       # int32 [F, C, NB]
    iir_reset,   # bool  [F, C, NB]
    iir_init,    # int32 [F, C, NB, 8]
    block_len,   # int32 [F, C, NB]
):
    """The filter over F frames × C channels, lane ``f*C + c``, from zero
    states: dvda_tpu's ``decode_step`` filter half
    (``mlp_filter_blocks`` then ``out.reshape(F, C, NB*S).transpose(0, 2,
    1)``).  Returns the frame-major channels int32 ``[F, NB*S, C]``; the
    final states are not made.  CUDA tensors go through one K1 launch
    writing that layout."""
    F, C, NB, S = residuals.shape
    flat = [x.reshape((F * C,) + tuple(x.shape[2:])) for x in (
        residuals, rc_fir, rc_iir, shift, quant, iir_reset, iir_init,
        block_len)]
    if on_cuda(residuals):
        return _launch(*flat, None, None, _LANE_IN, C,
                       final_states=False)[0]
    out = mlp_filter_blocks_tl_reference(flat[0].permute(1, 2, 0),
                                         *flat[1:], None, None)[0]
    return out.reshape(NB * S, F, C).transpose(0, 1).contiguous()

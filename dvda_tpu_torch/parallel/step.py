"""The fused decode step and its dp × tp sharded form.

Port of dvda_tpu/parallel/step.py.  One step is the MLP device pipeline
on a batch of restart-aligned frames: the AR filter (kernel K1,
ops/mlp_filter.py) on every (frame, channel) lane, then the frame-major
rematrix with LFSR noise, output shifts and WAVE permutation in one pass
(kernel K9, ops/rematrix.py::frame_remix).

K1 writes the frame-major channels ``[F, L, C]`` that K9 reads and starts
from zero states it does not upload (ops/mlp_filter.py::mlp_filter_frames),
so a step on a card is those two launches and nothing else.

Sharding (parallel/mesh.py): frames split over ``dp`` and channels over
``tp``.  K1 runs on each shard's device; the rematrix needs every channel
of a frame, so each dp row's channel shards are copied onto the row's
first device (dvda_tpu's all-gather over ``tp``), K9 runs there, and the
rows are concatenated on the grid's first device; an axis of one part
joins nothing.  It is one process driving every device of the grid, not
``torch.distributed``.

dvda_tpu's ``batch_shardings`` (the ``NamedSharding`` of each input that
its jit is given) has no counterpart: the step slices the batch itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.mlp_filter import mlp_filter_frames
from ..ops.rematrix import frame_remix

__all__ = ["DecodeBatch", "decode_step", "make_sharded_step",
           "example_batch"]

#: the per-(frame, channel) filter inputs, sharded over dp and tp
_LANE_FIELDS = ("residuals", "rc_fir", "rc_iir", "shift", "quant",
                "iir_reset", "iir_init", "block_len")
#: the per-frame rematrix inputs, sharded over dp
_FRAME_FIELDS = ("noise", "mat_coeff", "mat_noise", "mat_out", "mat_active",
                 "mat_quant", "bypassed", "output_shift")


class DecodeBatch(NamedTuple):
    """Inputs for one fused decode step over F frames × C channels.

    Frame f's channel c is filter lane ``f*C + c``; L = NB·S samples.
    """

    residuals: torch.Tensor   # int32 [F, C, NB, S]
    rc_fir: torch.Tensor      # int32 [F, C, NB, 8]
    rc_iir: torch.Tensor      # int32 [F, C, NB, 8]
    shift: torch.Tensor       # int32 [F, C, NB]
    quant: torch.Tensor       # int32 [F, C, NB]
    iir_reset: torch.Tensor   # bool  [F, C, NB]
    iir_init: torch.Tensor    # int32 [F, C, NB, 8]
    block_len: torch.Tensor   # int32 [F, C, NB]
    noise: torch.Tensor       # int32 [F, L, 2]
    mat_coeff: torch.Tensor   # int32 [F, 6, C]
    mat_noise: torch.Tensor   # int32 [F, 6, 2]
    mat_out: torch.Tensor     # int32 [F, 6]
    mat_active: torch.Tensor  # bool  [F, 6]
    mat_quant: torch.Tensor   # int32 [F, 6]
    bypassed: torch.Tensor    # int32 [F, 6, L]
    output_shift: torch.Tensor  # int32 [F, C]
    wave_perm: torch.Tensor   # int32 [C_out], on the host (K9 takes it by
                              # value; a device tensor costs a sync a step)


def _filtered(lanes: dict) -> torch.Tensor:
    """K1 over the ``[F, C, ...]`` lane inputs with zero initial states;
    returns the channels frame-major, int32 ``[F, L, C]``."""
    return mlp_filter_frames(*(lanes[k] for k in _LANE_FIELDS))


def decode_step(b: DecodeBatch) -> torch.Tensor:
    """Filter → rematrix → output; returns int32 [F, L, C_out] on the
    batch's device (K1 then K9 on a CUDA batch)."""
    channels = _filtered({k: getattr(b, k) for k in _LANE_FIELDS})
    return frame_remix(channels, *(getattr(b, k) for k in _FRAME_FIELDS),
                       b.wave_perm)


def make_sharded_step(mesh):
    """``decode_step`` over ``mesh``'s dp × tp grid: K1 on each
    (frame, channel) shard's device, each dp row's channels gathered onto
    its first device for K9, the rows concatenated on the grid's first
    device.  The step raises where F does not divide over dp or C over
    tp."""
    grid = mesh.devices
    dp, tp = grid.shape

    def step(b: DecodeBatch) -> torch.Tensor:
        F, C = b.residuals.shape[:2]
        if F % dp or C % tp:
            raise ValueError(f"F={F} frames over dp={dp} and C={C} channels "
                             f"over tp={tp} do not divide")
        Fs, Cs = F // dp, C // tp
        # every K1 shard first, so the devices filter side by side
        filtered = [[_filtered({
            k: getattr(b, k)[i * Fs:(i + 1) * Fs, j * Cs:(j + 1) * Cs]
            .to(grid[i, j]).contiguous() for k in _LANE_FIELDS})
            for j in range(tp)] for i in range(dp)]
        rows = []
        for i in range(dp):
            home = grid[i, 0]
            parts = [x.to(home) for x in filtered[i]]
            channels = parts[0] if tp == 1 else torch.cat(parts, 2)
            rows.append(frame_remix(
                channels, *(getattr(b, k)[i * Fs:(i + 1) * Fs].to(home)
                            .contiguous() for k in _FRAME_FIELDS),
                b.wave_perm))
        if dp == 1:
            return rows[0]
        return torch.cat([r.to(grid[0, 0]) for r in rows], 0)

    return step


def example_batch(F: int = 8, C: int = 8, NB: int = 4, S: int = 16,
                  C_out: int = 6, seed: int = 0,
                  device="cuda") -> DecodeBatch:
    """A random-but-valid batch honouring the kernels' invariants
    (17-bit coefficients, 16-bit matrix coefficients, shifts in range),
    drawn in the order of dvda_tpu's ``example_batch``: equal seeds give
    equal arrays.  Every tensor is on ``device`` but ``wave_perm``, a
    constant of the stream, which stays on the host."""
    rng = np.random.default_rng(seed)
    L = NB * S

    def i32(*shape, lo, hi):
        return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)

    batch = DecodeBatch(
        residuals=i32(F, C, NB, S, lo=-(1 << 16), hi=1 << 16),
        rc_fir=i32(F, C, NB, 8, lo=-(1 << 10), hi=1 << 10),
        rc_iir=i32(F, C, NB, 8, lo=-(1 << 10), hi=1 << 10),
        shift=i32(F, C, NB, lo=8, hi=14),
        quant=i32(F, C, NB, lo=0, hi=3),
        iir_reset=rng.random((F, C, NB)) < 0.2,
        iir_init=i32(F, C, NB, 8, lo=-(1 << 12), hi=1 << 12),
        block_len=np.full((F, C, NB), S, dtype=np.int32),
        noise=i32(F, L, 2, lo=-(1 << 10), hi=1 << 10),
        mat_coeff=i32(F, 6, C, lo=-(1 << 12), hi=1 << 12),
        mat_noise=i32(F, 6, 2, lo=-(1 << 12), hi=1 << 12),
        mat_out=i32(F, 6, lo=0, hi=C_out),
        mat_active=rng.random((F, 6)) < 0.7,
        mat_quant=i32(F, 6, lo=0, hi=3),
        bypassed=i32(F, 6, L, lo=0, hi=2),
        output_shift=i32(F, C, lo=0, hi=3),
        wave_perm=np.arange(C_out, dtype=np.int32),
    )
    return DecodeBatch(*(torch.from_numpy(x).to(device) for x in batch[:-1]),
                       torch.from_numpy(batch.wave_perm))

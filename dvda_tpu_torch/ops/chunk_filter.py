"""The filter of a uniform chunk, read from its arenas — kernel K1a and
its plain version.

Port of the filter call of dvda_tpu's chunk program
(codecs/mlp/native_engine.py:219-222, after the :111-267 front end):
per filter launch (the substreams of one ``(NB0, S0)``, fused on the
lane axis) the AR filter over the launch's lanes, from the three chunk
arenas (int32/int16/int8) and their static spec.  The filter inputs are
the front end's (``ops/chunk_lanes.py::chunk_lanes_reference``):
residuals time-leading, the parameter rows packed channel-major and
broadcast over each chain's blocks, ``iir_reset`` in block 0 only where
per chain, ``block_len`` = S0, zero initial states.  The result is the
chunk's series int32 ``[period, lanes of every launch]``: each launch's
filter output ``[NB0, S0, lanes]`` at its column offset, in launch
order, which is dvda_tpu's join of the launches
(``jnp.concatenate(parts, axis=1)``, native_engine.py:262-267) and needs
one period ``NB0*S0`` for every launch.  The final states are not made
(the chunk program discards them).

In device-Huffman mode K5 writes the residuals: ``residuals`` is then the
per-launch list of those buffers (K10 hands them out,
``chunk_lanes(...).residuals``).

On a CUDA tensor :func:`chunk_filter` launches csrc/chunk_filter.cu's
``mlp_filter_arena_kernel`` once per filter launch or raises: the filter
inputs never reach device memory.  On a CPU tensor it runs
:func:`chunk_filter_reference`: :func:`chunk_lanes_reference`, then
:func:`mlp_filter_blocks_tl_reference` per launch, joined by
``torch.cat``.
"""

from __future__ import annotations

import torch

from ..kernels.launch import check, current_stream, on_cuda, raise_on_error
from .chunk_lanes import check_arenas, chunk_lanes_reference, chunk_layout
from .mlp_filter import mlp_filter_blocks_tl_reference

__all__ = ["chunk_filter", "chunk_filter_reference"]


def _residuals_for(lay, residuals):
    """``residuals`` checked against the layout: required (one per filter
    launch) for a device-Huffman chunk, refused for a standard one."""
    if not lay.huffman:
        if residuals is not None:
            raise ValueError("chunk_filter: a standard chunk's residuals "
                             "are in its arenas")
        return [None] * len(lay.groups)
    if residuals is None or len(residuals) != len(lay.groups):
        raise ValueError(f"chunk_filter: a device-Huffman chunk needs "
                         f"{len(lay.groups)} residual buffer(s), K5's")
    return list(residuals)


def _series_shape(lay) -> tuple:
    """The chunk's series ``(period, lanes of every launch)``; raises
    where the launches' periods ``NB0*S0`` differ."""
    periods = {NB0 * S0 for NB0, S0, _, _ in lay.groups}
    if len(periods) != 1:
        raise ValueError(f"chunk_filter: the filter launches' periods "
                         f"NB0*S0 differ ({sorted(periods)}): their lanes "
                         "do not join into one series")
    return periods.pop(), sum(g[2] for g in lay.groups)


def chunk_filter_reference(a4, a2, a1, spec, residuals=None):
    """Plain PyTorch version: the front end's plain version, then K1's
    per filter launch, the launches joined by ``torch.cat``.  Same
    arguments and result as :func:`chunk_filter`."""
    lay = chunk_layout(spec)
    res = _residuals_for(lay, residuals)
    period, _ = _series_shape(lay)
    lanes = chunk_lanes_reference(a4, a2, a1, spec)
    return torch.cat([mlp_filter_blocks_tl_reference(
        *(args if r is None else (r,) + tuple(args[1:])))[0].reshape(
            period, -1) for args, r in zip(lanes.filters, res, strict=True)],
        dim=1)


def _launch(a4, a2, a1, lay, res, series) -> None:
    from ..kernels.build import kernel_library

    dev = a4.device
    check_arenas(a4, a2, a1, lay)
    for g, (r, (NB0, S0, lanes, _)) in enumerate(zip(res, lay.groups)):
        if r is not None:
            check(r, f"residuals {g}", torch.int32, (NB0, S0, lanes), dev)
    lib = kernel_library()
    col, ldo = 0, series.shape[1]
    with torch.cuda.device(dev):
        stream = current_stream(dev)
        for desc, r, (NB0, S0, lanes, _) in zip(lay.group_descs, res,
                                                lay.groups):
            rc = lib.dvda_chunk_filter(
                desc.ctypes.data, desc.size, a4.data_ptr(), a2.data_ptr(),
                a1.data_ptr(), a4.numel(), a2.numel(), a1.numel(),
                None if r is None else r.data_ptr(),
                series.data_ptr() + 4 * col,  # its columns, rows ldo apart
                lanes, NB0, S0, ldo, stream)
            if rc == -1:
                raise ValueError("chunk_filter: the kernel refused the "
                                 "descriptor (its layout differs from "
                                 "csrc/chunk_lanes.cuh)")
            raise_on_error(rc, "chunk_filter")
            chunk_filter.launches += 1
            col += lanes


def chunk_filter(a4, a2, a1, spec, residuals=None):
    """The chunk's series int32 ``[period, lanes of every launch]`` (see
    the module note), from its arenas and spec and, in device-Huffman
    mode, K5's residual buffers.  CUDA arenas go through kernel K1a, one
    launch per filter launch, each writing its columns of the series."""
    lay = chunk_layout(spec)
    res = _residuals_for(lay, residuals)
    shape = _series_shape(lay)
    chunk_filter.joined += len(lay.groups) > 1
    if not on_cuda(a4):
        return chunk_filter_reference(a4, a2, a1, spec, residuals)
    series = torch.empty(shape, dtype=torch.int32, device=a4.device)
    _launch(a4, a2, a1, lay, res, series)
    return series


#: kernel launches since the last reset (the CPU path never counts)
chunk_filter.launches = 0
#: chunks whose launches joined into one series (more than one launch),
#: on any device, since the last reset
chunk_filter.joined = 0

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
per chain, ``block_len`` = S0, zero initial states.  The result per
launch is the filter's output int32 ``[NB0, S0, lanes]``; the final
states are not made (the chunk program discards them).

In device-Huffman mode K5 writes the residuals: ``residuals`` is then the
per-launch list of those buffers (K10 hands them out,
``chunk_lanes(...).residuals``).

On a CUDA tensor :func:`chunk_filter` launches csrc/chunk_filter.cu's
``mlp_filter_arena_kernel`` once per filter launch or raises: the filter
inputs never reach device memory.  On a CPU tensor it runs
:func:`chunk_filter_reference`: :func:`chunk_lanes_reference`, then
:func:`mlp_filter_blocks_tl_reference` per launch.
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


def chunk_filter_reference(a4, a2, a1, spec, residuals=None) -> list:
    """Plain PyTorch version: the front end's plain version, then K1's
    per filter launch.  Same arguments and results as :func:`chunk_filter`."""
    lay = chunk_layout(spec)
    res = _residuals_for(lay, residuals)
    lanes = chunk_lanes_reference(a4, a2, a1, spec)
    return [mlp_filter_blocks_tl_reference(
        *(args if r is None else (r,) + tuple(args[1:])))[0]
        for args, r in zip(lanes.filters, res, strict=True)]


def _launch(a4, a2, a1, lay, res) -> list:
    from ..kernels.build import kernel_library

    dev = a4.device
    check_arenas(a4, a2, a1, lay)
    for g, (r, (NB0, S0, lanes, _)) in enumerate(zip(res, lay.groups)):
        if r is not None:
            check(r, f"residuals {g}", torch.int32, (NB0, S0, lanes), dev)
    lib = kernel_library()
    outs = []
    with torch.cuda.device(dev):
        stream = current_stream(dev)
        for desc, r, (NB0, S0, lanes, _) in zip(lay.group_descs, res,
                                                lay.groups):
            out = torch.empty((NB0, S0, lanes), dtype=torch.int32,
                              device=dev)
            rc = lib.dvda_chunk_filter(
                desc.ctypes.data, desc.size, a4.data_ptr(), a2.data_ptr(),
                a1.data_ptr(), a4.numel(), a2.numel(), a1.numel(),
                None if r is None else r.data_ptr(), out.data_ptr(), lanes,
                NB0, S0, stream)
            if rc == -1:
                raise ValueError("chunk_filter: the kernel refused the "
                                 "descriptor (its layout differs from "
                                 "csrc/chunk_lanes.cuh)")
            raise_on_error(rc, "chunk_filter")
            chunk_filter.launches += 1
            outs.append(out)
    return outs


def chunk_filter(a4, a2, a1, spec, residuals=None) -> list:
    """The filter output int32 ``[NB0, S0, lanes]`` of each filter launch
    of the chunk (see the module note), from its arenas and spec and, in
    device-Huffman mode, K5's residual buffers.  CUDA arenas go through
    kernel K1a, one launch per filter launch."""
    lay = chunk_layout(spec)
    if on_cuda(a4):
        return _launch(a4, a2, a1, lay, _residuals_for(lay, residuals))
    return chunk_filter_reference(a4, a2, a1, spec, residuals)


#: kernel launches since the last reset (the CPU path never counts)
chunk_filter.launches = 0

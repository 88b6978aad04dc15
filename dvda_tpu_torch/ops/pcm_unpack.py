"""PCM unpack — kernel K8 and its plain version.

The AOB byte de-swizzle and 16/24-bit sign extension of
dvda_tpu/ops/pcm_unpack.py::_unpack (reference: pcm.c:103-193), over a
track's ``[n, chunk_size]`` uint8 chunk batch.  The per-config gather table
is ``codecs.pcm.pcm_gather_indices``.  ``nbytes`` 2 or
3 writes the little-endian WAV payload instead of int32 samples: the bytes
``host.pcm_repack`` gives on dvda_tpu's PCM disc-to-WAV path.

On a CUDA tensor :func:`decode_chunks_device` launches csrc/pcm_unpack.cu
or raises (a batch at an address that is not 16-byte aligned raises: a
fresh allocation always is); on a CPU tensor it runs
:func:`decode_chunks_reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.pcm import chunk_size, pcm_gather_indices
from ..kernels.launch import check, current_stream, on_cuda, raise_on_error

__all__ = ["decode_chunks_device", "decode_chunks_reference"]


def _validate(chunks, bits_per_sample: int, channels: int, nbytes: int):
    if bits_per_sample not in (16, 20, 24):
        raise ValueError(f"bits_per_sample must be 16, 20 or 24, got "
                         f"{bits_per_sample}")
    if not 1 <= channels <= 6:
        raise ValueError(f"channels must be in 1..6, got {channels}")
    if nbytes not in (0, 2, 3):
        raise ValueError(f"nbytes must be 0, 2 or 3, got {nbytes}")
    csize = chunk_size(bits_per_sample, channels)
    check(chunks, "chunks", torch.uint8, (chunks.shape[0], csize),
          chunks.device)
    return csize


def _empty_out(n: int, channels: int, nbytes: int, device):
    if nbytes:
        return torch.empty((2 * n, channels * nbytes), dtype=torch.uint8,
                           device=device)
    return torch.empty((2 * n, channels), dtype=torch.int32, device=device)


def decode_chunks_reference(chunks: torch.Tensor, bits_per_sample: int,
                            channels: int, nbytes: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_chunks_device`: a gather on a
    zero-padded column, shift and sign extension (the torch form of
    ``decode_chunks_numpy``), then the little-endian byte split."""
    _validate(chunks, bits_per_sample, channels, nbytes)
    n = chunks.shape[0]
    idx = torch.from_numpy(pcm_gather_indices(bits_per_sample, channels)
                           .astype(np.int64)).to(chunks.device)
    padded = torch.cat([chunks, chunks.new_zeros((n, 1))], 1)
    g = padded[:, idx].to(torch.int64)                     # [n, 2ch, 3]
    if bits_per_sample == 16:
        val = g[..., 0] | (g[..., 1] << 8)
        val = (val ^ 0x8000) - 0x8000
    else:
        val = g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16)
        val = (val ^ 0x800000) - 0x800000
    val = val.reshape(2 * n, channels)
    if nbytes == 0:
        return val.to(torch.int32)
    pk = torch.stack([(val >> (8 * k)) & 0xFF for k in range(nbytes)], 2)
    return pk.to(torch.uint8).reshape(2 * n, channels * nbytes)


def _launch(chunks, bits_per_sample, channels, nbytes):
    from ..kernels.build import kernel_library

    csize = _validate(chunks, bits_per_sample, channels, nbytes)
    n = chunks.shape[0]
    dev = chunks.device
    out = _empty_out(n, channels, nbytes, dev)
    for name, t in (("chunks", chunks), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel moves 16-byte vectors and "
                             "needs 16-byte alignment")
    if n == 0:
        return out  # a zero-size grid is a CUDA error: nothing to launch
    table = np.ascontiguousarray(pcm_gather_indices(bits_per_sample,
                                                    channels), np.int32)
    lib = kernel_library()
    with torch.cuda.device(dev):
        rc = lib.dvda_pcm_unpack(chunks.data_ptr(), n, csize, channels,
                                 bits_per_sample, nbytes, table.ctypes.data,
                                 out.data_ptr(), current_stream(dev))
        decode_chunks_device.launches += 1
    raise_on_error(rc, "pcm_unpack")
    return out


def decode_chunks_device(chunks: torch.Tensor, bits_per_sample: int,
                         channels: int, nbytes: int = 0) -> torch.Tensor:
    """``chunks``: uint8 ``[n, chunk_size]``.  Returns int32 ``[2n,
    channels]`` (``nbytes`` 0) or the little-endian WAV payload, uint8
    ``[2n, channels * nbytes]`` (``nbytes`` 2 or 3), frame-major, two
    frames per chunk."""
    if on_cuda(chunks):
        return _launch(chunks, bits_per_sample, channels, nbytes)
    return decode_chunks_reference(chunks, bits_per_sample, channels, nbytes)


#: kernel launches since the last reset (the CPU path never counts)
decode_chunks_device.launches = 0

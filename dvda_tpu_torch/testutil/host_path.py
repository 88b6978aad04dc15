"""The port's C++ host path: one track's WAV data bytes with no kernel.

The witness the smoke run and the bench hold the device path against, and
time beside it: the packet walk + ``pcm_repack`` for PCM, the
host-complete reconstruction (``mp_reconstruct``) for MLP.  Both are the
port's copies of dvda_tpu's C++ (tests/test_torch_host.py holds them
against it).
"""

from __future__ import annotations

from .. import host
from ..api import TrackReader
from ..codecs.mlp.native_engine import decode_host_complete
from ..codecs.mlp.track import assemble_track_stream
from ..codecs.pcm import pcm_gather_indices
from ..config import DecodeConfig

__all__ = ["host_track_bytes"]


def host_track_bytes(aob, track, threads: int) -> bytes:
    """One track's WAV data bytes by the host path, reading its sectors
    from ``aob`` (an ``AOBReader`` or anything with its ``read_sectors``);
    ``threads`` MLP parse threads."""
    reader = TrackReader(aob, track, config=DecodeConfig(device="cpu"))
    if reader.codec == "PCM":
        chunks = reader._pcm_chunks()
        if chunks is None:
            raise RuntimeError(f"host path: track {track.number} gave no "
                               "PCM chunks")
        chunks = chunks.numpy()
        bits, ch = reader.bits_per_sample, reader.channel_count
        nb = bits // 8
        table = pcm_gather_indices(bits, ch)[:, :nb].reshape(-1)
        return bytes(host.pcm_repack(chunks, table, 2 * ch * nb,
                                     2 * chunks.shape[0] * ch * nb))
    stream, bnd, probe_end = assemble_track_stream(aob, track.span)
    return decode_host_complete(stream, bnd, probe_end, reader.parameters,
                                True, threads).tobytes()

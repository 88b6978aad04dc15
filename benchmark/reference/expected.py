"""What each track should decode to, worked out from what the generator
made, without the program.

MLP: the plain reference decoder (``mlp_spec.py``) decodes every unit of
the pool once; a track's samples are its layout's units in order, and its
WAV bytes those samples packed as ``bits_per_sample``-wide little-endian
fields (dvda2wav.c:326-334).  PCM: the AOB's byte swizzle undone with
pcm.c's scatter tables (pcm.c:103-166); a 16- or 24-bit sample's WAV
bytes are the unswizzled bytes themselves.

The same pass counts the logical work of each unit for the rooflines
(``roofline.py``): the filter taps of every sample and the rematrix
coefficients every frame uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fmt.params import (BPS_CODE, RATE_CODE, StreamParameters,
                          unpack_channel_count)
from .mlp_spec import MlpDecoder

__all__ = ["MlpReference", "mlp_reference", "pcm_wav", "pack_le",
           "AOB_BYTE_SWAP"]


class _CountingDecoder(MlpDecoder):
    """The reference decoder, counting multiply-accumulates: one a filter
    tap a sample, one a used rematrix coefficient a sample."""

    macs = 0

    def _filter_channel(self, ss, c):
        ch = ss.channels[c]
        self.macs += (len(ch.fir.coeff) + len(ch.iir.coeff)) * len(
            ss.residuals[c])
        return super()._filter_channel(ss, c)

    def _rematrix(self, ss):
        n = len(self._framelist[0])
        for m in ss.matrix_slots[: ss.matrix_len]:
            used = m.coeff[: ss.max_matrix_channel + 3]
            self.macs += n * sum(1 for v in used if v)
        super()._rematrix(ss)


def pack_le(samples: np.ndarray, bits_per_sample: int) -> np.ndarray:
    """int32 samples ``[..., n]`` as ``bits_per_sample``-wide little-endian
    bytes ``[..., n * bytes]`` (16 or 24 bits)."""
    width = bits_per_sample // 8
    b = np.ascontiguousarray(samples, "<i4").view(np.uint8)
    b = b.reshape(*samples.shape, 4)[..., :width]
    return np.ascontiguousarray(b).reshape(*samples.shape[:-1], -1)


@dataclass
class MlpReference:
    """The pool's decode: ``samples`` int32 ``[K, unit frames, channels]``
    in RIFF WAVE order, ``wav`` uint8 ``[K, unit WAV bytes]``, and each
    unit's stream bytes and multiply-accumulates."""

    samples: np.ndarray
    wav: np.ndarray
    stream_bytes: np.ndarray
    macs: np.ndarray

    def track_wav(self, layout: np.ndarray) -> np.ndarray:
        return self.wav[layout].reshape(-1)

    def track_samples(self, layout: np.ndarray, start: int,
                      count: int) -> np.ndarray:
        """Frames ``[start, start + count)`` of a track, clamped to it."""
        per = self.samples.shape[1]
        end = min(start + count, per * layout.size)
        if end <= start:
            return np.zeros((0, self.samples.shape[2]), np.int32)
        units = layout[start // per: (end - 1) // per + 1]
        rows = self.samples[units].reshape(-1, self.samples.shape[2])
        off = start - (start // per) * per
        return rows[off: off + end - start]


def mlp_reference(pool: list, cfg: dict) -> MlpReference:
    """Decode every unit of ``pool`` alone with the reference decoder."""
    params = StreamParameters(BPS_CODE[cfg["bits_per_sample"]], 0xF,
                              RATE_CODE[cfg["sample_rate"]], 0xF,
                              cfg["channel_assignment"])
    per = cfg["restart_every"] * cfg["blocks_per_frame"] * cfg["block_size"]
    ch = unpack_channel_count(cfg["channel_assignment"])
    samples = np.empty((len(pool), per, ch), np.int32)
    macs = np.empty(len(pool), np.int64)
    for i, unit in enumerate(pool):
        dec = _CountingDecoder(params)
        dec.decode_bytes(unit)
        got = dec.take_frames()
        if got.shape != (per, ch):
            raise RuntimeError(f"pool unit {i} decoded to {got.shape}, "
                               f"not {(per, ch)}")
        samples[i] = got
        macs[i] = dec.macs
    wav = pack_le(samples.reshape(len(pool), -1), cfg["bits_per_sample"])
    return MlpReference(samples, wav,
                        np.asarray([len(u) for u in pool], np.int64), macs)


# AOB_BYTE_SWAP[bps_index][channels-1] — scatter tables from pcm.c:103-138.
# bps_index 0 = 16-bit, 1 = 24-bit.
AOB_BYTE_SWAP: list[list[list[int]]] = [
    [  # 16 bps
        [1, 0, 3, 2],
        [1, 0, 3, 2, 5, 4, 7, 6],
        [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10],
        [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14],
        [1, 0, 3, 2, 5, 4, 7, 6, 9, 8, 11, 10, 13, 12, 15, 14, 17, 16, 19, 18],
        [5, 4, 7, 6, 17, 16, 19, 18, 1, 0, 3, 2,
         9, 8, 11, 10, 13, 12, 15, 14, 21, 20, 23, 22],
    ],
    [  # 24 bps
        [2, 1, 5, 4, 0, 3],
        [2, 1, 5, 4, 8, 7, 11, 10, 0, 3, 6, 9],
        [8, 7, 17, 16, 6, 15, 2, 1, 5, 4, 11, 10, 14, 13, 0, 3, 9, 12],
        [8, 7, 11, 10, 20, 19, 23, 22, 6, 9, 18, 21,
         2, 1, 5, 4, 14, 13, 17, 16, 0, 3, 12, 15],
        [8, 7, 11, 10, 14, 13, 23, 22, 26, 25, 29, 28,
         6, 9, 12, 21, 24, 27, 2, 1, 5, 4, 17, 16,
         20, 19, 0, 3, 15, 18],
        [8, 7, 11, 10, 26, 25, 29, 28, 6, 9, 24, 27,
         2, 1, 5, 4, 14, 13, 17, 16, 20, 19, 23, 22,
         32, 31, 35, 34, 0, 3, 12, 15, 18, 21, 30, 33],
    ],
]


def pcm_wav(chunks: np.ndarray, cfg: dict) -> np.ndarray:
    """The WAV bytes of a PCM track's chunks ``[n, chunk]``: pcm.c moves
    chunk byte ``i`` to position ``swap[i]`` of two frames of
    little-endian samples, which for 16- and 24-bit samples are the WAV
    payload's bytes as they stand."""
    bps = cfg["bits_per_sample"]
    if bps not in (16, 24):
        raise ValueError("the PCM reference covers 16- and 24-bit tracks")
    ch = unpack_channel_count(cfg["channel_assignment"])
    swap = AOB_BYTE_SWAP[bps == 24][ch - 1]
    inv = np.empty(len(swap), np.int64)
    inv[np.asarray(swap)] = np.arange(len(swap))
    return chunks[:, inv].reshape(-1)

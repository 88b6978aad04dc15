"""Stream parameter tables shared by the PCM and MLP codecs.

The benchmark's frozen copy of ``dvda_tpu_torch/codecs/params.py``, with the
packed-field encodings of the disc builder (``RATE_CODE``, ``BPS_CODE``)
beside it.

Reference analogs: struct stream_parameters (src/stream_parameters.h),
unpack_bits_per_sample / unpack_sample_rate / unpack_channel_count
(dvd-audio.c:1423-1496) and the MLP WAVE_CHANNEL permutation
(mlp.c:416-438).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "StreamParameters",
    "unpack_bits_per_sample",
    "unpack_sample_rate",
    "unpack_channel_count",
    "WAVE_CHANNEL",
    "PTS_PER_SECOND",
    "PCM_CODEC_ID",
    "MLP_CODEC_ID",
    "RATE_CODE",
    "BPS_CODE",
]

PTS_PER_SECOND = 90000
# packed-field encodings (inverse of dvd-audio.c:1423-1457)
RATE_CODE = {48000: 0, 96000: 1, 192000: 2, 44100: 8, 88200: 9, 176400: 10}
BPS_CODE = {16: 0, 20: 1, 24: 2}
PCM_CODEC_ID = 0xA0
MLP_CODEC_ID = 0xA1


@dataclass(frozen=True)
class StreamParameters:
    """The 5 packed fields probed from PCM packet headers / MLP major syncs."""

    group_0_bps: int
    group_1_bps: int
    group_0_rate: int
    group_1_rate: int
    channel_assignment: int

    @property
    def bits_per_sample(self) -> int:
        return unpack_bits_per_sample(self.group_0_bps)

    @property
    def sample_rate(self) -> int:
        return unpack_sample_rate(self.group_0_rate)

    @property
    def channel_count(self) -> int:
        return unpack_channel_count(self.channel_assignment)


_BPS = {0: 16, 1: 20, 2: 24}
_RATE = {0: 48000, 1: 96000, 2: 192000, 8: 44100, 9: 88200, 10: 176400}
_CHANNELS = {
    0: 1,
    1: 2,
    2: 3, 4: 3, 7: 3,
    3: 4, 5: 4, 8: 4, 10: 4, 13: 4, 15: 4,
    6: 5, 9: 5, 11: 5, 14: 5, 16: 5, 18: 5, 19: 5,
    12: 6, 17: 6, 20: 6,
}


def unpack_bits_per_sample(packed: int) -> int:
    """4-bit field → 16/20/24, or 0 if reserved (dvd-audio.c:1423-1436)."""
    return _BPS.get(packed, 0)


def unpack_sample_rate(packed: int) -> int:
    """4-bit field → Hz, or 0 if reserved (dvd-audio.c:1438-1457)."""
    return _RATE.get(packed, 0)


def unpack_channel_count(packed: int) -> int:
    """5-bit channel assignment → channel count (dvd-audio.c:1459-1496)."""
    return _CHANNELS.get(packed, 0)


# WAVE_CHANNEL[assignment][mlp_channel] -> RIFF WAVE channel index
# (mlp.c:416-438).  -1 marks channels absent for that assignment.
WAVE_CHANNEL: list[list[int]] = [
    [0, -1, -1, -1, -1, -1],  # 0x00
    [0, 1, -1, -1, -1, -1],   # 0x01
    [0, 1, 2, -1, -1, -1],    # 0x02
    [0, 1, 2, 3, -1, -1],     # 0x03
    [0, 1, 2, -1, -1, -1],    # 0x04
    [0, 1, 2, 3, -1, -1],     # 0x05
    [0, 1, 2, 3, 4, -1],      # 0x06
    [0, 1, 2, -1, -1, -1],    # 0x07
    [0, 1, 2, 3, -1, -1],     # 0x08
    [0, 1, 2, 3, 4, -1],      # 0x09
    [0, 1, 2, 3, -1, -1],     # 0x0A
    [0, 1, 2, 3, 4, -1],      # 0x0B
    [0, 1, 2, 3, 4, 5],       # 0x0C
    [0, 1, 2, 3, -1, -1],     # 0x0D
    [0, 1, 2, 3, 4, -1],      # 0x0E
    [0, 1, 2, 3, -1, -1],     # 0x0F
    [0, 1, 2, 3, 4, -1],      # 0x10
    [0, 1, 2, 3, 4, 5],       # 0x11
    [0, 1, 3, 4, 2, -1],      # 0x12
    [0, 1, 3, 4, 2, -1],      # 0x13
    [0, 1, 4, 5, 2, 3],       # 0x14
]

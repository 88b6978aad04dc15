"""The card's peaks and the logical work of each layer's kernels.

A roofline share is the least time the card could take over the work,
against the time the layer's kernels took (the sum of their records in
the profiler's trace), in percent.  The least time is the larger of the
bytes over the memory bandwidth and the integer operations over the
float32 CUDA-core rate (the convention of the port's kernel table: the
card has no faster integer path for this work).  The work is counted
from what was decoded, never from a kernel's layout, so a fused, split
or renamed kernel reads the same work:

* MLP: the stream bytes decoded plus the WAV bytes out; two operations
  (a multiply and an add) per filter tap of every sample and per used
  rematrix coefficient of every sample (``reference/expected.py`` counts
  them while it decodes).
* PCM: the chunk bytes in plus the WAV bytes out; no arithmetic to speak
  of.
* CPPM: the sector bytes in plus out; per sector the C2 rounds of its
  content key (five G evaluations of 10 key-schedule and 10 Feistel
  rounds) and of its D-CBC span (240 words of 10 Feistel rounds, the
  first keyed by a 10-round schedule, the rest by 2 rounds), at
  ``FEISTEL_OPS`` and ``KEY_ROUND_OPS`` operations a round.
"""

from __future__ import annotations

__all__ = ["PEAKS", "least_seconds", "cppm_ops_per_sector", "share"]

#: one NVIDIA H100 SXM (NVIDIA's data sheet, at a 700 W power limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "ops_per_s": 67e12}}

#: integer operations of one Feistel round: the add, the s-box load and
#: xor, two rotations of three operations each, two xors, the add into
#: the other half
FEISTEL_OPS = 12
#: one key-schedule round: the mask, the index xor, the s-box load, the
#: shift and add, two shift-or pairs of three operations each
KEY_ROUND_OPS = 11
WORDS_PER_SECTOR = 240
CONTENT_KEY_STEPS = 5


def cppm_ops_per_sector() -> int:
    g = 10 * KEY_ROUND_OPS + 10 * FEISTEL_OPS
    span = (WORDS_PER_SECTOR * 10 * FEISTEL_OPS
            + (10 + 2 * (WORDS_PER_SECTOR - 1)) * KEY_ROUND_OPS)
    return CONTENT_KEY_STEPS * g + span


def least_seconds(kind: str, n_bytes: float, ops: float) -> float:
    peak = PEAKS[kind]
    return max(n_bytes / peak["bytes_per_s"], ops / peak["ops_per_s"])


def share(kind: str, n_bytes: float, ops: float,
          kernel_seconds: float) -> float | None:
    """The roofline share in percent, or None where no kernel time was
    recorded or the card has no entry in :data:`PEAKS`."""
    if kernel_seconds <= 0 or kind not in PEAKS:
        return None
    return 100.0 * least_seconds(kind, n_bytes, ops) / kernel_seconds

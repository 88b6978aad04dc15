"""Milliseconds of the port's ``reader/bytes`` stage per audio second
decoded: the WAV payload copied into the ``bytes`` that ``read_all_packed``
returns."""

from benchmark.readers import stage_ms_per_audio_s


def read(run):
    return stage_ms_per_audio_s(run, "reader/bytes")

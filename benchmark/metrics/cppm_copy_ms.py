"""Milliseconds of the port's ``cppm/copy`` stage per audio second
decoded: the decryptor's host copies of each sector batch, into its
pinned buffer and out of it."""

from benchmark.readers import stage_ms_per_audio_s


def read(run):
    return stage_ms_per_audio_s(run, "cppm/copy")

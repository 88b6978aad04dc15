"""Milliseconds of the port's ``mlp/assemble`` stage per audio second
decoded."""

from benchmark.readers import stage_ms_per_audio_s


def read(run):
    return stage_ms_per_audio_s(run, "mlp/assemble")

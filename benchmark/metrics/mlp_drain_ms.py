"""Milliseconds of the port's ``mlp/device+d2h`` stage per audio second
decoded."""

from benchmark.readers import stage_ms_per_audio_s


def read(run):
    return stage_ms_per_audio_s(run, "mlp/device+d2h")

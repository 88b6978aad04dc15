"""Milliseconds of the port's ``mlp/geometry`` stage per audio second
decoded: the pipelined decode's section geometry and chain checks."""

from benchmark.readers import stage_ms_per_audio_s


def read(run):
    return stage_ms_per_audio_s(run, "mlp/geometry")

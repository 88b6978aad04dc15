"""Milliseconds of the port's ``mlp/throttle`` stage per audio second
decoded: the drain's wait for the first narrow flag."""

from benchmark.readers import stage_ms_per_audio_s


def read(run):
    return stage_ms_per_audio_s(run, "mlp/throttle")

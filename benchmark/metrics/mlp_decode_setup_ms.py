"""Milliseconds of the port's ``mlp/decode-setup`` stage per audio
second decoded: a decode's parse set-up and teardown and its drain's
pinned output buffer."""

from benchmark.readers import stage_ms_per_audio_s


def read(run):
    return stage_ms_per_audio_s(run, "mlp/decode-setup")

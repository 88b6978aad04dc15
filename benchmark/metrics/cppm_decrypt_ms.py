"""Milliseconds of the port's ``cppm/decrypt`` stage per audio second
decoded: the whole of ``CppmDecryptor.decrypt_sectors``, timed inside the
program (``cppm_hook_ms`` times the same call from the benchmark)."""

from benchmark.readers import stage_ms_per_audio_s


def read(run):
    return stage_ms_per_audio_s(run, "cppm/decrypt")

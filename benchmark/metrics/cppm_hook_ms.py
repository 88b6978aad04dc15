"""Milliseconds inside the CPPM hook (the ``decrypt=`` callback the
benchmark hands to ``AOBReader``, ``CppmDecryptor.decrypt_sectors``) per
audio second decoded, from the benchmark's own span around it."""

from benchmark.readers import span_ms_per_audio_s


def read(run):
    return span_ms_per_audio_s(run, "cppm.hook")

"""Milliseconds of the benchmark's ``rip.read_all_packed`` span per audio
second decoded that no top-level stage of the port holds: the span less
the sum of the stages below.  A stage nested in one of them (``mlp/widen``
in ``mlp/device+d2h``, ``cppm/*`` in the walk's stage) is not subtracted
again; a top-level stage the port adds belongs in the list."""

from benchmark.readers import span_ms_per_audio_s

#: the port's stages that no other stage holds, on the native paths of
#: ``TrackReader.read_all_packed``: pipelined, uniform and general MLP
#: (``mlp/words`` in device-Huffman mode), and PCM
TOP_LEVEL = ("mlp/assemble", "mlp/native-parse", "mlp/arena-build",
             "mlp/chunk-launch", "mlp/device+d2h", "mlp/geometry",
             "mlp/decode-setup", "mlp/throttle", "mlp/words",
             "mlp/general-tables", "mlp/general", "pcm/assemble",
             "pcm/unpack", "reader/bytes")


def read(run):
    span = span_ms_per_audio_s(run, "rip.read_all_packed")
    if span is None:
        return None
    staged = sum(run.stages.get(s, 0.0) for s in TOP_LEVEL)
    return span - 1e3 * staged / run.audio_s

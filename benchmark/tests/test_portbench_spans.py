"""The readers of the port's own spans on a hand-made run: milliseconds of
a stage per audio second, nothing where the stage never ran or no audio
was decoded, and the decode's time outside every top-level stage
(CPU)."""

from __future__ import annotations

import pytest

from benchmark.harness import RunContext, _reader

#: each new reader and the stage it reads
STAGE_READERS = {"mlp_geometry_ms": "mlp/geometry",
                 "mlp_decode_setup_ms": "mlp/decode-setup",
                 "mlp_throttle_ms": "mlp/throttle",
                 "reader_bytes_ms": "reader/bytes",
                 "cppm_decrypt_ms": "cppm/decrypt",
                 "cppm_copy_ms": "cppm/copy"}


def _run(stages=None, spans=None, audio_s=4.0):
    ctx = RunContext("fake", {}, {}, 1, True, "/nonexistent")
    ctx.stages = dict(stages or {})
    ctx.spans = dict(spans or {})
    ctx.audio_s = audio_s
    return ctx


@pytest.mark.parametrize("metric,stage", sorted(STAGE_READERS.items()))
def test_stage_reader_value(metric, stage):
    run = _run({stage: 0.002, "mlp/assemble": 1.0})
    assert _reader(metric)(run) == pytest.approx(0.5)  # 2 ms over 4 s


@pytest.mark.parametrize("metric", sorted(STAGE_READERS))
def test_stage_reader_reads_nothing(metric):
    assert _reader(metric)(_run({"mlp/assemble": 1.0})) is None
    stage = STAGE_READERS[metric]
    assert _reader(metric)(_run({stage: 0.002}, audio_s=0.0)) is None


def test_unstaged_subtracts_the_top_level_stages_only():
    read = _reader("decode_unstaged_ms")
    stages = {"mlp/assemble": 0.4, "mlp/native-parse": 1.0,
              "mlp/arena-build": 0.5, "mlp/chunk-launch": 0.3,
              "mlp/device+d2h": 0.6, "mlp/geometry": 0.1,
              "mlp/decode-setup": 0.2, "mlp/throttle": 0.05,
              "reader/bytes": 0.15,
              # nested: inside mlp/device+d2h and the walk's stage
              "mlp/widen": 0.6, "cppm/decrypt": 0.3, "cppm/copy": 0.2}
    run = _run(stages, {"rip.read_all_packed": 4.0, "rip.open": 1.0,
                        "cppm.hook": 0.3}, audio_s=100.0)
    # (4.0 - 3.3) s over 100 audio s
    assert read(run) == pytest.approx(7.0)
    pcm = _run({"pcm/assemble": 1.2, "pcm/unpack": 0.5, "reader/bytes": 0.1,
                "cppm/decrypt": 0.4}, {"rip.read_all_packed": 2.0}, 10.0)
    assert read(pcm) == pytest.approx(20.0)


def test_unstaged_reads_nothing_without_the_span_or_audio():
    read = _reader("decode_unstaged_ms")
    assert read(_run({"mlp/assemble": 0.4})) is None
    assert read(_run({}, {"rip.read_all_packed": 1.0}, audio_s=0.0)) is None
    # a run with the span and no stage of the list: all of it unstaged
    assert read(_run({}, {"rip.read_all_packed": 1.0})) == pytest.approx(250)

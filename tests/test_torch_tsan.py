"""ThreadSanitizer check of dvda_tpu_torch's multi-threaded MLP parser.

The port's parser (dvda_tpu_torch/host/src/mlp_parse.cc) merges finished
sections on a merger thread of its own while the caller steps and reads
what each step published.  This test builds it with ``-fsanitize=thread``
together with tests/torch_tsan_mt_parse.cc and runs clean, corrupted,
entry-damaged and bailing streams at several thread counts, failing on
any race report or MT/sequential mismatch.  The program also reads each
step's arrays while the merger runs, and frees parses straight after
begin and after one step."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from dvda_tpu_torch.codecs.mlp.codebooks import peek_lut
from dvda_tpu_torch.testutil import MlpSynthConfig, synth_mlp_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = dict(channel_assignment=17, substream_count=2, n_frames=1200, seed=7,
             major_sync_every=8, restart_every=8, blocks_per_frame=2,
             block_size=40)


def _tsan_available() -> bool:
    if shutil.which("g++") is None:
        return False
    probe = subprocess.run(
        ["g++", "-fsanitize=thread", "-x", "c++", "-", "-o", "/dev/null"],
        input=b"int main(){return 0;}", capture_output=True)
    return probe.returncode == 0


pytestmark = pytest.mark.skipif(not _tsan_available(),
                                reason="g++ with -fsanitize=thread unavailable")


@pytest.fixture(scope="module")
def tsan_program(tmp_path_factory):
    work = tmp_path_factory.mktemp("torch_tsan")
    exe = work / "torch_tsan_mt_parse"
    subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=thread", "-std=c++17", "-o", str(exe),
         os.path.join(REPO, "tests", "torch_tsan_mt_parse.cc"),
         os.path.join(REPO, "dvda_tpu_torch", "host", "src", "mlp_parse.cc")],
        check=True, capture_output=True, timeout=300)
    return work, exe


def _frame_starts(stream):
    starts, off = [], 0
    while off + 4 <= len(stream):
        total = (((stream[off] & 0x0F) << 8) | stream[off + 1]) * 2
        if total < 4 or off + total > len(stream):
            break
        starts.append(off)
        off += total
    return starts


def _case(kind):
    """(stream, bytes the program flips) of one kind of input."""
    if kind == "bail":  # no check data: a damaged frame bails the parse
        stream = synth_mlp_stream(MlpSynthConfig(**dict(
            SYNTH, n_frames=600, major_sync_every=4, restart_every=4,
            checkdata=False)))
        return stream, [_frame_starts(stream)[302] + 174]
    stream = synth_mlp_stream(MlpSynthConfig(**SYNTH))
    if kind == "clean":
        return stream, []
    if kind == "corrupted":  # damage inside sections
        return stream, [200000, 400000]
    starts = _frame_starts(stream)  # sections' entry frames: local repairs
    return stream, [starts[fi] + 40 for fi in (160, 312, 464, 696, 1080)]


@pytest.mark.parametrize("kind", ["clean", "corrupted", "entries", "bail"])
def test_mt_parse_thread_sanitizer(tsan_program, kind):
    work, exe = tsan_program
    stream, flips = _case(kind)
    path = work / f"{kind}.bin"
    path.write_bytes(stream)
    luts = np.zeros((2, 4, 512), dtype=np.int32)
    for k in (1, 2, 3):
        luts[0, k], luts[1, k] = peek_lut(k)
    (work / f"{kind}.bin.luts").write_bytes(luts.tobytes())
    for threads in (2, 4, 8):
        result = subprocess.run(
            [str(exe), str(path), str(threads), *map(str, flips)],
            capture_output=True, text=True, timeout=240)
        out = result.stdout + result.stderr
        assert result.returncode == 0, out
        assert "EQUAL" in result.stdout, out
        assert "WARNING: ThreadSanitizer" not in out
        if kind == "bail":
            assert "status=1" in result.stdout, out
        else:
            assert "status=0" in result.stdout, out

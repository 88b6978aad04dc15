"""Small albums for the benchmark's CPU tests: the configurations' own
keys with fewer, shorter tracks and a smaller MLP pool, and no timed
warm-up."""

from __future__ import annotations

import os
import time
from unittest import mock

SMALL = {"mlp": {"tracks": 2, "track_seconds": 4, "pool_units": 8},
         "pcm": {"tracks": 2, "track_seconds": 1}}
#: no timed warm-up (a rip still decodes the album once before the window)
SHORT = {"warmup_seconds": 0}


#: cells that the drivers serve and ``BENCHMARK.json`` does not list (the
#: seek traffic, see ``drivers/seek.py``), for the tests alone
UNLISTED = [{"name": "mlp51_96k24.seek", "config": "mlp51_96k24",
             "traffic": "seek", "chips": 1,
             "why": "seek requests over the MLP album"}]


def with_unlisted():
    """Patch the harness's manifest so that it also holds ``UNLISTED``."""
    from benchmark import harness

    manifest = harness.load_manifest()
    manifest["workloads"] = manifest["workloads"] + UNLISTED
    return mock.patch.object(harness, "load_manifest", lambda: manifest)


def small(cell: str) -> dict:
    return SMALL["mlp" if cell.startswith("mlp") else "pcm"]


def run_small(cell: str, seed: int = 2147483999, seconds: float = 4.0,
              trace: bool = False, **config) -> dict:
    """One run of ``cell`` on the CPU (the kernels' plain versions) at a
    small size, in this process; ``config``: configuration keys replaced
    besides the size."""
    from benchmark.harness import run_cell
    from benchmark.trace import Capture

    os.environ["DVDA_TPU_TORCH_DEVICE"] = "cpu"
    capture = Capture() if trace else None
    with with_unlisted():
        return run_cell(cell, seed, seconds, trace, time.perf_counter(),
                        require_cuda=False, capture=capture,
                        overrides=dict(small(cell), **config),
                        traffic_overrides=SHORT)

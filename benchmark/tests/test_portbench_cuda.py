"""The benchmark's cells end to end on the card at a small size (marked
``cuda``: skips without a CUDA device; run on the chip with
``python -m pytest -m cuda benchmark/tests``)."""

from __future__ import annotations

import time

import pytest

from benchmark.tests.small import SHORT, small, with_unlisted

CELLS = ["mlp51_96k24.rip", "pcm20_192k24_cppm.rip", "mlp51_96k24.seek"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark.harness import run_cell

    with with_unlisted():
        r = run_cell(cell, 2147484000, 2.0, False, time.perf_counter(),
                     overrides=small(cell), traffic_overrides=SHORT)
    assert r["correct"] and r["device"]["platform"] == "gpu"

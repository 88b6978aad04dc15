"""The trace's idle labels: each idle piece of the window by the innermost
range of the main thread that holds it, however many ranges a long one
holds (CPU, synthetic ranges)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import pytest

from benchmark.trace import _label_gaps


def _labels(busy, w0, w1, spans, ops=()):
    cpu = [(lo, hi, n, True) for lo, hi, n in spans]
    cpu += [(lo, hi, n, False) for lo, hi, n in ops]
    return dict(_label_gaps(busy, w0, w1, cpu))


def test_a_range_of_200_ranges_labels_its_own_gaps():
    # "walk" holds 200 siblings of 10 ns with 5 ns gaps, then 105 ns
    # after the last; the card is busy through every sibling
    spans = [(0, 3_100, "walk")]
    spans += [(15 * k, 15 * k + 10, f"decrypt{k % 2}") for k in range(200)]
    busy = [[15 * k, 15 * k + 10] for k in range(200)]
    got = _labels(busy, 0, 3_200, spans)
    # 199 gaps of 5 ns between the siblings, and 105 ns after them
    assert got == pytest.approx({"walk": (199 * 5 + 105) * 1e-9,
                                 "outside": 100e-9})
    assert "decrypt0" not in got and "decrypt1" not in got


def test_nested_and_adjacent_ranges():
    # labelled as the bounded look-back labelled them
    spans = [(0, 100, "a"), (10, 40, "b"), (20, 30, "c"), (40, 60, "d"),
             (100, 150, "e"), (150, 160, "f"), (105, 120, "g")]
    # the operation names the piece that holds it at the piece's middle
    got = _labels([], 0, 200, spans, ops=[(25, 28, "aten::op")])
    assert got == pytest.approx({
        "a": 50e-9, "b": 20e-9, "c > aten::op": 10e-9, "d": 20e-9,
        "e": 35e-9, "g": 15e-9, "f": 10e-9, "outside": 40e-9})


def test_ranges_that_start_together_and_ranges_past_the_window():
    spans = [(-50, 30, "early"), (10, 20, "inner"), (10, 80, "outer"),
             (70, 500, "late")]
    got = _labels([[40, 60]], 0, 100, spans)
    # the later start is the inner range where two overlap
    assert got == pytest.approx({"early": 10e-9, "inner": 10e-9,
                                 "outer": 30e-9, "late": 30e-9})


def _innermost_brute(spans, t):
    """The latest-starting range holding ``t`` (the shorter on a tie)."""
    held = [s for s in spans if s[0] <= t < s[1]]
    return max(held, key=lambda s: (s[0], -s[1]))[2] if held else "outside"


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_nested_ranges_match_the_innermost_by_brute_force(seed):
    rng = np.random.default_rng(seed)
    spans = []

    def grow(lo, hi, depth):
        t = lo
        while depth < 5 and t < hi - 4:
            a = int(rng.integers(t, hi - 3))
            b = int(rng.integers(a + 1, min(hi, a + 200) + 1))
            spans.append((a, b, f"r{len(spans)}"))
            grow(a, b, depth + 1)
            t = b + int(rng.integers(0, 3))

    grow(0, 2_000, 0)
    busy = []
    for a in sorted(rng.choice(2_000, 40, replace=False)):
        if busy and a <= busy[-1][1]:
            continue
        busy.append([int(a), int(a) + int(rng.integers(1, 20))])
    got = _labels(busy, 0, 2_000, spans)
    want = defaultdict(int)
    idle = np.ones(2_000, bool)
    for lo, hi in busy:
        idle[lo:hi] = False
    for t in np.flatnonzero(idle):
        want[_innermost_brute(spans, int(t))] += 1
    want = sorted(((n, c * 1e-9) for n, c in want.items()),
                  key=lambda kv: -kv[1])[:10]
    assert got == pytest.approx(dict(want))

"""The MLP 2.0/192k/24 album and its rip cell: the manifest lists the cell
on the plain 5.1 MLP cell's metrics and on ``mlp_redo_share``, its
configuration differs from the 5.1 one in the stream's shape alone, the
cell runs correct at a small size untraced and traced (CPU), and
``mlp_redo_share`` reads the share of the MLP kernels' records launched
inside the port's ``mlp/redo`` range."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.harness import ROOT, RunContext, _reader, load_manifest
from benchmark.tests.small import run_small
from benchmark.trace import WINDOW, read_events
from benchmark.tests.test_portbench_metrics import _Event

CELL, TWIN = "mlp20_192k24.rip", "mlp51_96k24.rip"
#: what the two configuration files may say differently: names, texts and
#: the stream's shape
TEXTS = {"name", "deployment", "source", "guarantees", "reduced", "assumed"}
SHAPE = {"channel_assignment", "substreams", "sample_rate", "block_size"}


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_the_cell_is_on_the_twins_metrics_and_the_redo_share():
    m = load_manifest()
    cell = {w["name"]: w for w in m["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "mlp20_192k24", "rip", 1)
    listed = {e["name"] for e in m["end_to_end"] + m["per_layer"]
              if CELL in e.get("workloads", ())}
    twin = {e["name"] for e in m["end_to_end"] + m["per_layer"]
            if TWIN in e.get("workloads", ())}
    assert listed == twin | {"mlp_redo_share"}
    redo = {e["name"]: e for e in m["per_layer"]}["mlp_redo_share"]
    assert (redo["unit"], redo["better"], redo["source"], redo["moves"]) == (
        "%", "lower", "device_trace", "x_realtime")


def test_the_configuration_is_the_5_1_one_in_another_shape():
    five, two = _config("mlp51_96k24"), _config("mlp20_192k24")
    assert set(two) == set(five)
    for key in set(five) - TEXTS - SHAPE:
        assert two[key] == five[key], key
    assert {k: two[k] for k in SHAPE} == {
        "channel_assignment": 1, "substreams": 1, "sample_rate": 192000,
        "block_size": 80}
    assert set(two["reduced"]) == set(five["reduced"]) == {"tracks"}
    entry = {c["name"]: c for c in load_manifest()["configs"]}[two["name"]]
    assert entry["file"] == "benchmark/configs/mlp20_192k24.json"
    assert entry["reduced"] == ["tracks"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_is_correct_at_a_small_size(trace):
    r = run_small(CELL, trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    if not trace:
        assert set(r["metrics"]) == {"x_realtime", "setup_s"}


def _capture(unattributed: bool):
    """A chunk's K1a and K234n launched in ``mlp/chunk-launch``, its redo's
    K234 inside ``mlp/redo`` nested in ``mlp/throttle``, and a decrypt
    kernel inside the CPPM hook."""
    ev = [_Event(WINDOW, 0, 10_000, ann=True),
          _Event("rip.read_all_packed", 10, 9_000, ann=True),
          _Event("cppm.hook", 20, 60, ann=True),
          _Event("mlp/chunk-launch", 100, 200, ann=True),
          _Event("mlp/throttle", 300, 400, ann=True),
          _Event("mlp/redo", 310, 390, ann=True),
          _Event("cudaLaunchKernel", 30, 35, corr=10),
          _Event("cudaLaunchKernel", 150, 155, corr=11),
          _Event("cudaLaunchKernel", 160, 165, corr=12),
          _Event("cudaLaunchKernel", 350, 355, corr=13),
          _Event("c2_decrypt_kernel", 500, 1_500, cuda=True, corr=10),
          _Event("mlp_filter_arena_kernel", 2_000, 2_600, cuda=True, corr=11),
          _Event("output_stage_kernel", 2_600, 2_900, cuda=True, corr=12),
          _Event("output_stage_kernel", 3_000, 3_100, cuda=True, corr=13),
          _Event("Memcpy DtoH", 4_000, 5_000, cuda=True, corr=99)]
    if unattributed:
        ev.append(_Event("no_launch", 6_000, 6_100, cuda=True, corr=77))
    return ev


@pytest.mark.parametrize("unattributed", [False, True])
@pytest.mark.parametrize("encrypted", [False, True])
def test_the_redo_share_reads_the_redo_range(unattributed, encrypted):
    run = RunContext("fake", {}, {}, 1, True, "/nonexistent")
    run.trace_result = read_events(_capture(unattributed), {})
    run.work = {"mlp": {"bytes": 1.0, "ops": 0.0}}
    if encrypted:
        run.work["cppm"] = {"bytes": 1.0, "ops": 0.0}
    got = _reader("mlp_redo_share")(run)
    if unattributed:
        assert got is None
    elif encrypted:
        # 100 ns of redo over the 1,000 ns of MLP kernels
        assert got == pytest.approx(10.0)
    else:
        # every kernel of a plain disc is the MLP decode's
        assert got == pytest.approx(100 * 100 / 2_000)


def test_the_redo_share_reads_nothing_without_the_range():
    """A run whose records hold no launch inside ``mlp/redo`` (a program
    without the range, or no chunk run again) reads nothing, though its
    other records could be read; so does an untraced run."""
    run = RunContext("fake", {}, {}, 1, True, "/nonexistent")
    run.work = {"mlp": {"bytes": 1.0, "ops": 0.0}}
    run.trace_result = read_events(_capture(False), {})
    assert _reader("mlp_redo_share")(run) is not None
    run.trace_result = read_events(
        [e for e in _capture(False) if e.name() != "mlp/redo"], {})
    assert run.trace_result.kernel_seconds() > 0
    assert _reader("mlp_redo_share")(run) is None
    run.trace_result = None
    assert _reader("mlp_redo_share")(run) is None

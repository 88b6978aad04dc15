"""``BENCHMARK.json`` against the benchmark contract's rules on names,
units, files and sizes, and every name it holds found as a file."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark.harness import ROOT, load_manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per)")
M = load_manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    with open(os.path.join(ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(M["command"]) <= 32 and all(map(_line, M["command"]))
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and os.path.isdir(
            os.path.join(ROOT, p))


def test_check_budget_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in M[k]]
        assert len(ns) == len(set(ns))
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not WIDTH.search(key)
            assert key in cfg["reduced"]  # the file says why


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        moves = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moves)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in M["workloads"]:
        e2e = [m for m in M["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m for m in M["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert len(e2e) >= 2 and layer


@pytest.mark.parametrize("kind,folder", [("per_layer", "metrics")])
def test_every_name_is_found_as_a_file(kind, folder):
    here = os.path.join(ROOT, "benchmark")
    for m in M[kind]:
        assert os.path.exists(os.path.join(here, folder, f"{m['name']}.py"))
    for w in M["workloads"]:
        path = os.path.join(here, "traffic", f"{w['traffic']}.json")
        with open(path) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(here, "drivers", f"{driver}.py"))

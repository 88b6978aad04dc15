"""The CPPM-protected MLP album and its rip cell: the manifest lists the
cell on the plain MLP cell's metrics and on the CPPM hook's, and on no
other, and its configuration differs from the plain MLP one by the
encryption alone."""

from __future__ import annotations

import json
import os

from benchmark.harness import ROOT, load_manifest

CELL, TWIN = "mlp51_96k24_cppm.rip", "mlp51_96k24.rip"
#: what the two configuration files may say differently: names, texts and
#: the encryption
TEXTS = {"name", "deployment", "source", "guarantees", "reduced"}


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_the_cell_is_on_the_twins_and_the_hooks_metrics_alone():
    m = load_manifest()
    cell = {w["name"]: w for w in m["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "mlp51_96k24_cppm", "rip", 1)
    listed = {e["name"] for e in m["end_to_end"] + m["per_layer"]
              if CELL in e.get("workloads", ())}
    twin = {e["name"] for e in m["per_layer"]
            if TWIN in e.get("workloads", ())}
    cppm = {e["name"] for e in m["per_layer"]
            if e["name"].startswith("cppm_")}
    assert len(twin) == 12 and len(cppm) == 4
    assert listed == {"x_realtime"} | twin | cppm
    # every per-layer metric has a list, so none reaches the cell unlisted
    assert all("workloads" in e for e in m["per_layer"])


def test_the_configuration_is_the_plain_one_encrypted():
    plain, enc = _config("mlp51_96k24"), _config("mlp51_96k24_cppm")
    assert set(enc) - set(plain) == {"key_source"}
    assert set(plain) <= set(enc)
    for key in set(plain) - TEXTS - {"encrypted"}:
        assert enc[key] == plain[key], key
    assert plain["encrypted"] is False and enc["encrypted"] is True
    assert enc["key_source"] == "seed"
    assert set(enc["reduced"]) == {"tracks", "key_source"}
    assert enc["reduced"]["tracks"] == plain["reduced"]["tracks"]
    entry = {c["name"]: c for c in load_manifest()["configs"]}[enc["name"]]
    assert entry["file"] == "benchmark/configs/mlp51_96k24_cppm.json"
    assert entry["reduced"] == ["tracks", "key_source"]

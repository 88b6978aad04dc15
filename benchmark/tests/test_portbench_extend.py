"""A later change adds a configuration, a cell and a per-layer metric by
adding files and entries only: in a copy of the benchmark, nothing that
is there edited, the new cell runs and reports the new metric (CPU)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import ROOT


def _copy(tmp_path) -> dict:
    """A copy of the benchmark under ``tmp_path``; its files' bytes."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}


def _unedited(before: dict) -> None:
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data


def _run(tmp_path, cell: str, overrides: dict, traffic=None) -> tuple:
    """The copy's ``cell`` run untraced, then traced, in a process of its
    own (CPU), with configuration and traffic keys replaced: the two
    result lines."""
    code = (
        "import json, os, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]\n"
        "os.environ['DVDA_TPU_TORCH_DEVICE'] = 'cpu'\n"
        "from benchmark.harness import run_cell, ROOT\n"
        f"assert ROOT == {str(tmp_path)!r}, ROOT\n"
        "from benchmark.trace import Capture\n"
        "for trace in (0, 1):\n"
        f"    r = run_cell({cell!r}, 5, 0.5, bool(trace),\n"
        "                 time.perf_counter(), require_cuda=False,\n"
        "                 capture=Capture() if trace else None,\n"
        f"                 overrides={overrides!r},\n"
        f"                 traffic_overrides={traffic!r})\n"
        "    print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    return tuple(json.loads(x) for x in out.stdout.splitlines()[-2:])


def test_a_cell_a_config_and_a_metric_as_files_only(tmp_path):
    before = _copy(tmp_path)
    bench = tmp_path / "benchmark"
    with open(bench / "configs" / "pcm20_192k24_cppm.json") as f:
        cfg = json.load(f)
    cfg.update(name="pcm51_96k24", channel_assignment=20,
               sample_rate=96000, encrypted=False)
    (bench / "configs" / "pcm51_96k24.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "rip_twice.json").write_text(json.dumps(
        {"driver": "rip", "warmup_seconds": 0, "compare_share": 1.0}))
    (bench / "metrics" / "decodes_per_s.py").write_text(
        "def read(run):\n"
        "    return len(run.latencies_ms) or run.audio_s\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][1],
                                    name="pcm51_96k24",
                                    file="benchmark/configs/pcm51_96k24.json",
                                    reduced=["tracks"]))
    manifest["workloads"].append({"name": "pcm51_96k24.rip_twice",
                                  "config": "pcm51_96k24",
                                  "traffic": "rip_twice", "chips": 1,
                                  "why": "a new cell"})
    for m in manifest["end_to_end"]:
        if m["name"] == "x_realtime":
            m["workloads"].append("pcm51_96k24.rip_twice")
    manifest["per_layer"].append({"name": "decodes_per_s", "unit": "1/s",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "reader", "moves": "setup_s",
                                  "workloads": ["pcm51_96k24.rip_twice"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    _unedited(before)
    plain, traced = _run(tmp_path, "pcm51_96k24.rip_twice",
                         {"track_seconds": 1, "tracks": 2})
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"x_realtime", "setup_s"}
    assert "decodes_per_s" in traced["metrics"]


#: the metrics an encrypted MLP cell joins: the rip's rate and the CPPM
#: hook's readers
CPPM_MLP_METRICS = ("x_realtime", "cppm_hook_ms", "cppm_decrypt_ms",
                    "cppm_copy_ms", "cppm_kernel_roofline")


def test_an_encrypted_mlp_disc_as_files_only(tmp_path):
    before = _copy(tmp_path)
    bench = tmp_path / "benchmark"
    with open(bench / "configs" / "mlp51_96k24.json") as f:
        cfg = json.load(f)
    cfg.update(name="mlp51_96k24_cppm", encrypted=True, key_source="seed")
    (bench / "configs" / "mlp51_96k24_cppm.json").write_text(json.dumps(cfg))
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(
        manifest["configs"][0], name="mlp51_96k24_cppm",
        file="benchmark/configs/mlp51_96k24_cppm.json",
        reduced=["tracks", "key_source"]))
    manifest["workloads"].append({"name": "mlp51_96k24_cppm.rip",
                                  "config": "mlp51_96k24_cppm",
                                  "traffic": "rip", "chips": 1,
                                  "why": "an encrypted MLP album"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in CPPM_MLP_METRICS:
            m["workloads"].append("mlp51_96k24_cppm.rip")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    _unedited(before)
    # one track: the window's first decode checks the whole album
    plain, traced = _run(tmp_path, "mlp51_96k24_cppm.rip",
                         {"track_seconds": 4, "tracks": 1, "pool_units": 8},
                         {"warmup_seconds": 0})
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"x_realtime", "setup_s"}
    assert traced["metrics"]["cppm_hook_ms"]["value"] > 0
    assert traced["metrics"]["cppm_decrypt_ms"]["value"] > 0

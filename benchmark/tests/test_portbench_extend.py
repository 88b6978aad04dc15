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


def test_a_cell_a_config_and_a_metric_as_files_only(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
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
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data
    code = (
        "import json, os, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]\n"
        "os.environ['DVDA_TPU_TORCH_DEVICE'] = 'cpu'\n"
        "from benchmark.harness import run_cell, ROOT\n"
        f"assert ROOT == {str(tmp_path)!r}, ROOT\n"
        "from benchmark.trace import Capture\n"
        "for trace in (0, 1):\n"
        "    r = run_cell('pcm51_96k24.rip_twice', 5, 0.5, bool(trace),\n"
        "                 time.perf_counter(), require_cuda=False,\n"
        "                 capture=Capture() if trace else None,\n"
        "                 overrides={'track_seconds': 1, 'tracks': 2})\n"
        "    print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"x_realtime", "setup_s"}
    assert "decodes_per_s" in traced["metrics"]

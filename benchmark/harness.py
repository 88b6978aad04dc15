"""One run of one cell: set-up, the measured window, the check of what
the window produced, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: the cell's entry in ``BENCHMARK.json`` names its
configuration (``configs[].file``, a JSON file of the deployment) and its
traffic (``benchmark/traffic/<traffic>.json``, whose ``driver`` names the
module ``benchmark/drivers/<driver>.py`` that runs it), and each
per-layer metric is read by ``benchmark/metrics/<metric>.py``.  A later
change adds a cell, a configuration or a metric by adding files and
entries.

A driver module gives ``Driver(ctx, cache_dir)`` with ``prepare()`` (the
album on disk), ``setup()`` (the rest of the set-up: reader objects,
warm-up), ``window(seconds)`` (the measured loop), ``release()`` (drop
the program's state), ``check()`` (the comparison with the reference once
the window has closed: ``(attempted, failed, checks)``, each check a
(value, limit) pair) and ``end_to_end()`` (its end-to-end metrics by
name).
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

__all__ = ["ROOT", "load_manifest", "run_cell", "RunContext", "Failure",
           "FORBIDDEN_MODULES", "forbidden_modules"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level module names that no run may load, compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dvda_tpu")
#: build and kernel caches: fixed directories inside the checkout
CACHE_DIR = os.path.join(ROOT, "build", "benchmark")


class Failure(RuntimeError):
    """A run that must print no result: ``code`` is its exit code."""

    def __init__(self, msg: str, code: int):
        super().__init__(msg)
        self.code = code


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names
                   if m.split(".", 1)[0] in FORBIDDEN_MODULES})


def _refuse_forbidden(after: str) -> None:
    found = forbidden_modules()
    if found:
        raise Failure(f"forbidden modules loaded after {after}: "
                      + ", ".join(found), 3)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclass
class RunContext:
    """What a driver and the metric readers see of a run."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    trace: bool
    workdir: str
    decode_config: object = None
    #: the port's stage totals (``global_timer``), seconds, over the window
    stages: dict = field(default_factory=dict)
    #: the benchmark's own spans over the window: name -> seconds
    spans: dict = field(default_factory=dict)
    #: audio seconds the window finished
    audio_s: float = 0.0
    #: logical work in the window by layer: {"bytes": .., "ops": ..}
    work: dict = field(default_factory=dict)
    #: request latencies of the window, ms
    latencies_ms: list = field(default_factory=list)
    trace_result: object = None
    device_kind: str = ""
    #: spans add to :attr:`spans` only inside the window
    counting: bool = False

    def span(self, name: str):
        """A benchmark span around a call into the program: its seconds
        add to :attr:`spans` while ``counting`` is on, and in a traced run
        it is a ``record_function`` range."""
        return _Span(self, name)


class _Span:
    def __init__(self, ctx: RunContext, name: str):
        self.ctx, self.name = ctx, name

    def __enter__(self):
        if self.ctx.trace:
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.ctx.counting:
            self.ctx.spans[self.name] = self.ctx.spans.get(self.name, 0) + dt
        if self.ctx.trace:
            self._rf.__exit__(*exc)


def _reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def _host_sample() -> float:
    """This process's CPU seconds, every thread, user and system."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _host_report(cpu0: float, cpu1: float, wall: float) -> str:
    """The cores this process kept busy over the window: a run that is
    slower on the same work with as many CPU seconds ran slower per
    instruction; with fewer, it waited."""
    return (f"window {wall:.3f} s, process cpu {cpu1 - cpu0:.3f} s, "
            f"{(cpu1 - cpu0) / wall:.3f} of {os.cpu_count()} cores")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_start: float, require_cuda: bool = True,
             capture=None, overrides: dict | None = None,
             traffic_overrides: dict | None = None) -> dict:
    """Run ``cell`` once and return its result line as a dict.  Raises
    :class:`Failure` where the run must print no result.  ``t_start``:
    the process's start on ``time.perf_counter``'s clock (set-up counts
    from it).  ``capture``: the running trace capture of a ``--trace 1``
    run.  ``overrides``, ``traffic_overrides``: configuration and traffic
    keys replaced (the tests' small albums and short warm-ups)."""
    import torch

    manifest = load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if cell not in cells:
        raise Failure(f"unknown workload {cell!r}", 2)
    entry = cells[cell]
    if require_cuda:
        if not torch.cuda.is_available():
            raise Failure("no CUDA device: the benchmark measures the card",
                          2)
        if torch.cuda.device_count() < entry["chips"]:
            raise Failure(f"{cell} needs {entry['chips']} CUDA devices, "
                          f"{torch.cuda.device_count()} visible", 2)
    conf = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    config.update(overrides or {})
    with open(os.path.join(HERE, "traffic", f"{entry['traffic']}.json")) as f:
        traffic = json.load(f)
    traffic.update(traffic_overrides or {})
    driver_mod = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")

    from dvda_tpu_torch.config import default_config
    from dvda_tpu_torch.utils.profiling import global_timer, kernel_launches

    decode_config = default_config()
    cuda = decode_config.resolved_device().type == "cuda"
    if require_cuda and not cuda:
        raise Failure(f"the decode device is not CUDA: {decode_config.device}",
                      2)
    workdir = tempfile.mkdtemp(prefix="dvda-bench-")
    ctx = RunContext(cell, config, traffic, seed, trace, workdir,
                     decode_config=decode_config)
    try:
        driver = driver_mod.Driver(ctx, CACHE_DIR)
        driver.prepare()
        if cuda:
            # the program's peak from here: warm-up and window
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t_prep = time.perf_counter()
        driver.setup()
        stages0 = dict(global_timer.totals)
        launches0 = kernel_launches()
        ctx.counting = True
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        host0 = _host_sample()
        win = capture.window() if capture else contextlib.nullcontext()
        with win:
            driver.window(seconds)
        ctx.counting = False
        host = _host_report(host0, _host_sample(), time.perf_counter() - t0)
        launches = {k: v - launches0.get(k, 0)
                    for k, v in kernel_launches().items()}
        ctx.stages = {k: v - stages0.get(k, 0.0)
                      for k, v in global_timer.totals.items()}
        _refuse_forbidden("the window")
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": entry["chips"] if cuda else 0,
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
                  if cuda else 0}
        ctx.device_kind = device["kind"]
        if capture is not None:
            ctx.trace_result = capture.finish(launches)
            device["busy_s"] = ctx.trace_result.busy_s
            device["window_s"] = ctx.trace_result.window_s
            if ctx.trace_result.gate:
                _log(f"[trace] {ctx.trace_result.gate}: the device-trace "
                     "metrics read nothing")
            if ctx.trace_result.unattributed:
                _log(f"[trace] {ctx.trace_result.unattributed}: the "
                     "rooflines that take kernels by range read nothing")
        driver.release()
        attempted, failed, checks = driver.check()
        correct = failed == 0 and all(v <= lim for v, lim in checks.values())
        metrics = {}
        if trace:
            for m in manifest["per_layer"]:
                if _applies(m, cell):
                    value = _reader(m["name"])(ctx)
                    if value is not None:
                        metrics[m["name"]] = {"value": value,
                                              "unit": m["unit"]}
        else:
            values = dict(driver.end_to_end(), setup_s=setup_s)
            for m in manifest["end_to_end"]:
                if _applies(m, cell):
                    metrics[m["name"]] = {"value": values[m["name"]],
                                          "unit": m["unit"]}
        _log(f"[card] {_card_line() if cuda else 'cpu'}")
        _log(f"[host] {host}")
        _log(f"[setup] {t_prep - t_start:.3f} s to the album, "
             f"{t0 - t_prep:.3f} s of warm-up")
        _log("[stages] " + json.dumps({k: round(v, 6) for k, v in
                                        sorted(ctx.stages.items())}))
        result = {"correct": correct, "attempted": attempted,
                  "failed": failed, "metrics": metrics, "device": device}
        if ctx.trace_result is not None:
            result["breakdown"] = {
                "device_ops": ctx.trace_result.device_ops,
                "idle_gaps": ctx.trace_result.idle_gaps}
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        # the check, the readers and the trace may load modules too
        _refuse_forbidden("the check and the readers")
        for k, (v, lim) in checks.items():
            _log(f"check {k} {v} limit {lim}")
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

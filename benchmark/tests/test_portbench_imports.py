"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (so ``dvda_tpu_torch`` passes), and no file
of the benchmark imports the port's bench, smoke or test helpers."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import FORBIDDEN_MODULES, ROOT, forbidden_modules

BANNED_PREFIXES = ("dvda_tpu_torch.testutil", "dvda_tpu_torch.cli.bench",
                   "chip_smoke")


def test_whole_top_level_names():
    mods = {"dvda_tpu_torch", "dvda_tpu_torch.api", "jaxlib.xla_client",
            "dvda_tpu.api", "jax", "flax.linen", "jaxtyping", "dvda_tpux"}
    assert forbidden_modules(mods) == ["dvda_tpu.api", "flax.linen", "jax",
                                       "jaxlib.xla_client"]
    assert forbidden_modules({"dvda_tpu_torch.ops"}) == []


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_no_file_of_the_benchmark_imports_what_it_may_not():
    here = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(here):
        for name in files:
            if not name.endswith(".py"):
                continue
            for mod in _imports(os.path.join(dirpath, name)):
                top = mod.split(".", 1)[0]
                assert top not in FORBIDDEN_MODULES, (name, mod)
                assert not mod.startswith(BANNED_PREFIXES), (name, mod)


def test_reference_and_generator_import_nothing_of_the_program():
    here = os.path.join(ROOT, "benchmark")
    for sub in ("reference", "gen", "fmt"):
        for name in os.listdir(os.path.join(here, sub)):
            if name.endswith(".py"):
                for mod in _imports(os.path.join(here, sub, name)):
                    assert not mod.startswith("dvda_tpu"), (sub, name, mod)


#: a run whose check loads a forbidden module: it must end in Failure 3
_LOADS_IN_CHECK = """
import types
from benchmark.drivers import rip
from benchmark.harness import Failure
check = rip.Driver.check
def loading_check(self):
    sys.modules["jax"] = types.ModuleType("jax")
    return check(self)
rip.Driver.check = loading_check
try:
    run_small('mlp51_96k24.rip', seconds=2.5)
except Failure as exc:
    assert exc.code == 3 and "jax" in str(exc), exc
else:
    raise AssertionError("a run that loaded jax in its check gave a result")
"""

_CLEAN = """
r = run_small('mlp51_96k24.rip', seconds=2.5)
from benchmark.harness import forbidden_modules
assert r['correct'] and not forbidden_modules(), forbidden_modules()
"""


@pytest.mark.parametrize("body", [_CLEAN, _LOADS_IN_CHECK],
                         ids=["clean", "loads_in_check"])
def test_a_run_loads_no_forbidden_module(body):
    code = ("import os, sys, time\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from benchmark.tests.small import run_small\n" + body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]

"""Run one cell of the benchmark of ``dvda_tpu_torch`` once:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The last line on standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, every number the
comparison with the reference judged, beside its limit, which are also
the last lines on standard error.  Without a CUDA device, or with fewer
than the cell asks for, the run exits 2 and prints no result; with a
forbidden module loaded (``jax``, ``jaxlib``, ``flax``, ``dvda_tpu``) it
exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _environment(root: str) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX."""
    cache = os.path.join(root, "build", "benchmark")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from .harness import ROOT, Failure, run_cell

    _environment(ROOT)
    capture = None
    if args.trace:
        from .trace import Capture

        capture = Capture()
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_START, capture=capture)
    except Failure as exc:
        print(f"benchmark: {exc}", file=sys.stderr, flush=True)
        return exc.code
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

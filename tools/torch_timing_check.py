#!/usr/bin/env python3
"""Cross-check of the ways to time the port's kernels on one NVIDIA GPU.

    python3 tools/torch_timing_check.py

Each kernel runs at a fixed shape on synthetic data made from a seed,
timed four ways in one process:

* ``queued``: CUDA events around calls that the host queues while the card
  waits in a spin kernel (``chip_smoke._device_ms``, the smoke's kernel
  time);
* ``graph``: the replay of a CUDA graph that captured the same calls;
* ``profiler``: ``torch.profiler``'s kernel records (CUPTI), summed and
  divided by the number of calls, with the number of records beside it;
* ``back to back``: CUDA events over calls made one after another
  (``chip_smoke._cuda_ms``), which also hold the wrapper's host time.

The shapes: K6a and K6b on a general-path substream pair of 150,000
blocks (``testutil.general_inputs``), K9 at 6,000 frames x 80 samples,
K234 at the headline chunk with L0 of 40, 80 and 160, and ``torch.take``
of 30 M int32.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _profiler_ms(fn, reps: int) -> tuple[float, int]:
    """(ms per call, number of kernel records) from one profiler window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    us = sum(e.device_time_total for e in events)
    return us / reps / 1e3, sum(e.count for e in events)


def _report(smoke, label: str, fn, reps: int) -> None:
    for _ in range(3):
        fn()
    queued = smoke._device_ms(fn, reps)
    graph = _graph_ms(fn, reps)
    prof, records = _profiler_ms(fn, reps)
    back = smoke._cuda_ms(fn, reps)
    print(f"{label}: queued {queued:.4f} ms, graph {graph:.4f} ms, profiler "
          f"{prof:.4f} ms ({records} kernel records for {reps} calls), back "
          f"to back {back:.4f} ms", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_timing_check: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from dvda_tpu_torch.kernels.build import kernel_library
    from dvda_tpu_torch.ops.general_gather import lane_pack, series_remix
    from dvda_tpu_torch.ops.rematrix import frame_remix, output_stage
    from dvda_tpu_torch.testutil import (frame_remix_inputs, general_inputs,
                                         output_stage_inputs)

    smoke.phase_device()
    kernel_library()
    dev = torch.device("cuda", 0)

    def to_dev(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    subs, frames = general_inputs(3, n_blocks=150000, S=40, F=2000,
                                  n_ch=(2, 4))
    subs = [{k: v if k == "S" else to_dev(v) for k, v in u.items()}
            for u in subs]
    frames = tuple(to_dev(f) for f in frames)
    _report(smoke, "K6a lane_pack, 2 substreams",
            lambda: [lane_pack(u) for u in subs], 20)
    gen = torch.Generator(device="cpu").manual_seed(0)
    outs = []
    for u in subs:
        n_ch = u["shift"].shape[1]
        shape = (u["bidx"].shape[1], u["S"], u["bidx"].shape[0] * n_ch)
        outs.append((torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                   dtype=torch.int32).to(dev),
                     u["series_idx"], n_ch))
    _report(smoke, f"K6b series_remix, T={frames[1].shape[0]}",
            lambda: series_remix(outs, *frames), 20)
    k9 = [to_dev(a) for a in frame_remix_inputs(1, 6000, 80, 8, 6)]
    k9[9] = k9[9].cpu()  # wave_perm is read on the host
    _report(smoke, "K9 frame_remix, 6000 x 80, 8 -> 6 ch, 5 slots",
            lambda: frame_remix(*k9, 5), 20)
    for L0, fpc in ((40, 16), (80, 8), (160, 4)):
        args = [to_dev(v) for v in output_stage_inputs(
            1, 256, fpc, L0, 6, 6, n_active=3).values()]
        _report(smoke, f"K234 output_stage, 256 chains x {fpc} x L0={L0}",
                lambda: output_stage(*args, chains=256, n_mats=3, nbytes=3),
                50)
    src = torch.randint(0, 1000, (50_000_000,), dtype=torch.int32,
                        device=dev)
    idx = torch.randint(0, 50_000_000, (30_000_000,), device=dev)
    _report(smoke, "torch.take, 30 M of 50 M int32", lambda: src.take(idx),
            20)
    return 0


if __name__ == "__main__":
    sys.exit(main())

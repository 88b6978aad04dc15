#!/usr/bin/env python3
"""Cross-check of the ways to time the port's kernels on one NVIDIA GPU.

    python3 tools/torch_timing_check.py

Each kernel runs at a fixed shape on synthetic data made from a seed,
timed four ways in one process:

* ``queued``: CUDA events around calls that the host queues while the card
  waits in a spin kernel (``dvda_tpu_torch.utils.profiling.device_ms``,
  the kernel time of the smoke run and the bench);
* ``graph``: the replay of a CUDA graph that captured the same calls;
* ``profiler``: ``torch.profiler``'s kernel records (CUPTI), summed and
  divided by the number of calls, with the number of records beside it;
* ``back to back``: CUDA events over calls made one after another
  (``dvda_tpu_torch.utils.profiling.events_ms``), which also hold the
  wrapper's host time.

The shapes: K6a and K6b on a general-path substream pair of 150,000
blocks (``testutil.general_inputs``), K9 at 6,000 frames x 80 samples,
K234 at the headline chunk with L0 of 40, 80 and 160, and ``torch.take``
of 30 M int32.  Exits non-zero without CUDA.

    python3 tools/torch_timing_check.py chains

times instead what bounds the serial kernel K1: a one-warp probe built
with ``nvcc`` into ``build/`` (the SM clock under one warp; cycles per
instruction of a dependent chain and of eight independent chains for the
32 x 32 -> 64-bit integer multiply-add, the float64 multiply-add and the
shared-memory load; cycles per sample of K1's float64 group on its own),
then K1 at the headline chunk [16, 40, 1,536] with every block full and
16-bit taps (its float64 groups), the same 640 samples as one block of
640, full-range taps (its one-sample step) and the smoke's pattern of half
blocks (queued card time, ns and cycles per dependent step).  The probe
also times K7's chain (csrc/c2_decrypt.cuh) with its tables in shared
memory: one C2 round after another, and one D-CBC word's chain after
another (the 2-round schedule, then rounds 9..5), and the kernel's pass
(the same with the previous word's rounds 4..0 beside it), and prints the
chain of a sector (240 words and the content key's 50 rounds) in ms at
the measured clock.

    python3 tools/torch_timing_check.py k1 PARENT

times K1 of this checkout against K1 of another checkout at PARENT (its
``csrc/mlp_filter.cu`` built alone with ``nvcc`` into ``build/``), both
launched through their C interface on the same inputs in one process, in
the order parent, change, change, parent: at the headline chunk (the
smoke's inputs), at the fused step's 2,048 lanes (``example_batch`` as
``decode_step`` flattens it) and at the churn disc's widest substream
(K6a's outputs on the smoke's general-path disc, [32, 40, 18,000]).  The
two kernels' outputs must be equal.

    python3 tools/torch_timing_check.py k7 PARENT
    python3 tools/torch_timing_check.py k8 PARENT

do the same for K7 and K8, each built alone from PARENT's
``csrc/c2_decrypt.cu`` or ``csrc/pcm_unpack.cu``: K7 on the smoke's
first 4,096-sector batch of its CPPM disc and on that disc's last 284
sectors (a track's tail batch), each call on its own fresh copy of the
encrypted batch (K7 synthesises the smoke's CPPM disc: ~1.5 min of
host); K8 on the smoke's 30 s 5.1/96k/24 PCM track and its 2.0/48k/16
one, packed and int32.

    python3 tools/torch_timing_check.py k234n PARENT
    python3 tools/torch_timing_check.py k6b PARENT

do the same for K234n and K6b, built alone from PARENT's
``csrc/output_stage.cu`` or ``csrc/general_gather.cu``: K234n at the
smoke's headline chunk at tiers 16 and 12 (the parent's call zeroes a
fresh misfit word, runs its kernel and then its flag kernel; the change's
is one launch on the stream's persistent scratch) and K234 wide, 24-bit,
at the same chunk; K6b on K1's outputs of the smoke's churn disc
(synthesised: ~70 s of host).

    python3 tools/torch_timing_check.py k9 PARENT

does the same for K9, built alone from PARENT's ``csrc/frame_remix.cu``:
at the fused step's batch (``example_batch`` at the smoke's ``STEP``,
channels from K1) and on the arguments the Python engine passes it on the
smoke's 5 s engine disc (synthesised and decoded with
``use_native=False``: ~30 s of host).

    python3 tools/torch_timing_check.py k10 PARENT

times K10 (a device-Huffman chunk's K5 inputs) alone at the smoke's
headline chunk (its first 256 chains, arenas on the card; the stream
synthesised to those chains' 2,056 frames), then the whole chunk
program (``uniform_arena_pipeline``) of this checkout against the chunk
program of the checkout at PARENT, in both modes, on the same arenas,
in the order parent, change, change, parent (queued card time, and per
call back to back by CUDA events, 10 calls a figure).  PARENT's package
is imported under another name and builds its kernels into its own
``build/``.  The two programs' outputs must be equal.

    python3 tools/torch_timing_check.py k1a PARENT

does the same with K1a alone first (the filter reading the chunk
arenas: at the standard headline chunk, and in device Huffman on the
residuals that K10 and K5 write, K10 timed alone too), then the chunk
program here (standard: K1a and K234n; device Huffman: K10, 2 x K5,
K1a, K234n) against PARENT's, both modes, parent, change, change,
parent.
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
    from dvda_tpu_torch.utils.profiling import device_ms, events_ms

    for _ in range(3):
        fn()
    queued = device_ms(fn, reps)
    graph = _graph_ms(fn, reps)
    prof, records = _profiler_ms(fn, reps)
    back = events_ms(fn, reps)
    print(f"{label}: queued {queued:.4f} ms, graph {graph:.4f} ms, profiler "
          f"{prof:.4f} ms ({records} kernel records for {reps} calls), back "
          f"to back {back:.4f} ms", flush=True)


_PROBE = r"""
// One warp on one SM, each kernel timed by CUDA events: the SM clock, the
// issue of single instructions (a dependent chain, eight independent
// chains), and K1's float64 group (csrc/mlp_filter.cuh) on its own,
// residuals from shared memory and values stored as the kernel does.
#include <cstdio>
#include <cstdint>
#include "mlp_filter.cuh"
#include "c2_decrypt.cuh"
constexpr int N = 1 << 16;
__global__ void spin(long long cycles) {
  const long long t = clock64();
  while (clock64() - t < cycles) {}
}
template <int op>
__global__ void chain(int a, int b, double x, double y, long long* sink) {
  __shared__ unsigned sm[1024];
  for (int i = threadIdx.x; i < 1024; i += 32) sm[i] = (i * 7 + 1) & 1023;
  __syncwarp();
  int64_t w[8];
  double d[8];
  unsigned p = threadIdx.x;
  for (int j = 0; j < 8; ++j) w[j] = a + j + threadIdx.x, d[j] = x + j;
  for (int i = 0; i < N; ++i) {
    if (op == 0) w[0] = (int64_t)(int32_t)w[0] * b + w[0];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (op == 1) w[j] = (int64_t)(int32_t)w[j] * b + w[j];
      if (op == 3) d[j] = fma(d[j], x, y);
    }
    if (op == 2) d[0] = fma(d[0], x, y);
    if (op == 4) p = sm[p];
  }
  long long s = p;
  for (int j = 0; j < 8; ++j) s += w[j] + (long long)d[j];
  sink[threadIdx.x] = s;
}
__global__ void group(int groups, int32_t* out, long long* sink) {
  __shared__ int32_t tile[kFilterGroup][kFilterLanes];
  for (int j = 0; j < kFilterGroup; ++j)
    tile[j][threadIdx.x] = (j * 37 + threadIdx.x * 11) % 200 - 100;
  __syncwarp();
  MlpFilterLane L = {};
  for (int k = 0; k < 8; ++k) {
    L.cur.fc[k] = L.cur.ic[k] = (k & 1 ? -1 : 1) * (k + 1) * 3;
    L.fs[k] = L.is[k] = threadIdx.x + k;
    L.fcd[k] = L.icd[k] = L.cur.fc[k];
  }
  L.cur.sh = 6;
  L.scale = 1.0 / 64;
  L.mask = ~0u;
  for (int g = 0; g < groups; ++g)
    mlp_filter_run_f64(L, tile, threadIdx.x, 0, out + threadIdx.x,
                       kFilterLanes);
  sink[threadIdx.x] = (long long)L.acc + L.fs[7];
}
// K7's chain: word 0 a round after another (mode 0), a D-CBC word's chain
// after another (mode 1: the 2-round schedule from the last word's state,
// rounds 9..5), or the kernel's pass (mode 2), the tables in static shared
// memory as the kernel's
__global__ void c2_chain(int mode, long long* sink) {
  __shared__ uint32_t tab[2 * 256];
  for (int i = threadIdx.x; i < 2 * 256; i += 32)
    tab[i] = (uint32_t)i * 2654435761u;
  __syncwarp();
  const C2Tables t{tab, tab + 256};
  uint32_t L = threadIdx.x * 77u, R = threadIdx.x * 13u + 1, ka = 5,
           kb = threadIdx.x;
  uint32_t pL = L ^ 3u, pR = R ^ 5u, q0 = 7, q1 = 11;
  if (mode == 0) {
    for (int i = 0; i < N; ++i) c2_round(L, R, kb, t);
  } else {
    for (int i = 0; i < N; ++i) {
      uint32_t s0, s1;
      c2_schedule2(ka, kb, s0, s1, t);
      if (mode == 1) {
        c2_round(L, R, s1, t);
        c2_round(L, R, s0, t);
        c2_round(L, R, s1, t);
        c2_round(L, R, s0, t);
        c2_round(L, R, s1, t);
      } else {  // the kernel's pass: word w-1's rounds 4..0 beside
        c2_rounds_pair(L, R, s0, s1, pL, pR, q0, q1, t);
        q0 = s0, q1 = s1, pL = L, pR = R;
      }
      ka = 0x1234u ^ (R & 0x00FFFFFFu);
      kb = 0x5678u ^ L;
    }
  }
  sink[threadIdx.x] = L ^ R ^ pL ^ pR;
}
static float ms(void (*launch)(void*), void* arg) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch(arg);
  cudaEventRecord(e0);
  launch(arg);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float t;
  cudaEventElapsedTime(&t, e0, e1);
  return t;
}
long long* sink;
int32_t* out;
template <int op> void run_chain(void*) {
  chain<op><<<1, 32>>>(3, 5, 1.0000001, 0.5, sink);
}
void run_group(void*) { group<<<1, 32>>>(N / kFilterGroup, out, sink); }
void run_spin(void*) { spin<<<1, 32>>>(1LL << 26); }
template <int mode> void run_c2(void*) { c2_chain<<<1, 32>>>(mode, sink); }
int main() {
  cudaMalloc(&sink, 32 * sizeof(long long));
  cudaMalloc(&out, kFilterGroup * kFilterLanes * sizeof(int32_t));
  const double mhz = (1 << 26) / (ms(run_spin, nullptr) * 1e3);
  printf("  SM clock under one warp %.0f MHz\n", mhz);
  struct { const char* name; void (*fn)(void*); int per; } t[] = {
      {"IMAD.WIDE dependent", run_chain<0>, 1},
      {"IMAD.WIDE 8 chains", run_chain<1>, 8},
      {"DFMA dependent", run_chain<2>, 1},
      {"DFMA 8 chains", run_chain<3>, 8},
      {"LDS dependent", run_chain<4>, 1},
      {"K1 float64 group of 8, a sample", run_group, 1}};
  for (auto& r : t)
    printf("  %-34s %.1f cycles\n", r.name,
           ms(r.fn, nullptr) * 1e3 * mhz / ((double)N * r.per));
  const double round = ms(run_c2<0>, nullptr) * 1e3 * mhz / N;
  const double word = ms(run_c2<1>, nullptr) * 1e3 * mhz / N;
  const double pass = ms(run_c2<2>, nullptr) * 1e3 * mhz / N;
  printf("  K7 C2 round %.1f cycles; a word's chain %.1f cycles, the "
         "kernel's pass %.1f; a sector's chain (240 words, 50 key rounds) "
         "%.4f ms\n", round, word, pass,
         (240 * word + 50 * round) / (mhz * 1e3));
  return cudaGetLastError() != cudaSuccess;
}
"""


def _chains(smoke) -> int:
    """K1's groups and the card's instruction rates (see the module note)."""
    import subprocess

    import numpy as np
    import torch

    from dvda_tpu_torch.kernels.build import ARCH_FLAGS, _nvcc
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl
    from dvda_tpu_torch.testutil import filter_inputs

    out = os.path.join(ROOT, "build", "k1_probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "probe.cu"), "w") as f:
        f.write(_PROBE)
    subprocess.run([_nvcc()] + ARCH_FLAGS + [
        "-std=c++17", "-O3", "-I", os.path.join(ROOT, "dvda_tpu_torch", "csrc"),
        "-o",
        os.path.join(out, "probe"), os.path.join(out, "probe.cu")],
        check=True)
    probe = subprocess.run([os.path.join(out, "probe")], capture_output=True,
                           text=True)
    print("one warp:\n" + probe.stdout, end="", flush=True)
    mhz = float(probe.stdout.split("MHz")[0].split()[-1])
    dev = torch.device("cuda", 0)
    B = 1536
    for label, (NB, S), extreme, full in (
            ("16-bit taps, full blocks (float64)", (16, 40), False, True),
            ("16-bit taps, one block (float64)", (1, 640), False, True),
            ("full-range taps, full blocks (one-sample step)", (16, 40), 2,
             True),
            ("16-bit taps, the smoke's half blocks", (16, 40), False,
             False)):
        args = [torch.from_numpy(np.asarray(a)).to(dev)
                for a in filter_inputs(0, B, NB, S, extreme, states=True)]
        if full:
            args[7] = torch.full_like(args[7], S)
        ms = smoke._times(lambda: mlp_filter_blocks_tl(*args), 50)[0]
        print(f"K1 [{NB}, {S}, {B}], {label}: {ms:.4f} ms on the card, "
              f"{ms * 1e6 / (NB * S):.1f} ns = "
              f"{ms * 1e3 * mhz / (NB * S):.0f} cycles at {mhz:.0f} MHz per "
              "dependent step", flush=True)
    return probe.returncode


def _built_alone(name: str, checkout: str, source: str, symbol: str,
                 argtypes: list):
    """``symbol`` of ``csrc/<source>`` in the checkout at ``checkout``,
    built alone with ``nvcc`` into ``build/<name>``."""
    import ctypes
    import subprocess

    from dvda_tpu_torch.kernels.build import NVCC_FLAGS, _nvcc

    out = os.path.join(ROOT, "build", name)
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, f"lib{name}.so")
    csrc = os.path.join(os.path.abspath(checkout), "dvda_tpu_torch", "csrc")
    subprocess.run([_nvcc()] + NVCC_FLAGS + [
        "-shared", "-I", csrc, "-o", lib, os.path.join(csrc, source)],
        check=True)
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _k1_parent(parent: str):
    """The ``dvda_mlp_filter`` of the checkout at ``parent``, built alone."""
    import ctypes

    return _built_alone("k1_parent", parent, "mlp_filter.cu",
                        "dvda_mlp_filter", [ctypes.c_void_p] * 13
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _k1_launcher(fn, args):
    """(a call of ``fn`` on the ten K1 arguments ``args``, its outputs)."""
    import torch

    NB, S, B = args[0].shape
    outs = (torch.empty_like(args[0]), torch.empty_like(args[8]),
            torch.empty_like(args[9]))
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*ptrs, B, NB, S, stream)
        if rc:
            raise RuntimeError(f"dvda_mlp_filter: CUDA error {rc}")

    return call, outs


def _churn_general(smoke, dev) -> tuple:
    """The smoke's general-path disc as the general path builds it on the
    card: (K6a's outputs per substream, the substream tables, the frame
    tables after K6b's ``outs``)."""
    import tempfile

    import numpy as np
    import torch

    import dvda_tpu_torch
    from dvda_tpu_torch import host
    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.codecs.mlp.track import assemble_track_stream
    from dvda_tpu_torch.ops.general_gather import lane_pack

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        layout, frames = smoke.phase_synth_general(work)
        reader = (dvda_tpu_torch.open_disc(layout.path).open_titleset(1)
                  .open_title(1).open_track(1).open_reader())
        stream, bnd, probe_end = assemble_track_stream(reader.aob,
                                                       reader.track.span)
    inc = host.parse_mlp_stream_begin(stream)
    try:
        inc.step(0)
        v = inc.view()
        F = ne._frame_cut(v.frame_end, np.asarray(bnd, dtype=np.int64),
                          probe_end)
        subs, tabs = ne.general_tables(v, F, frames, 6, dev)
        packed = [lane_pack(u) for u in subs]
        torch.cuda.synchronize()
    finally:
        inc.close()
    return packed, subs, tabs


def _churn_k1_args(smoke, dev) -> tuple:
    """K1's arguments at the smoke's general-path disc's widest substream:
    the disc's tables as the general path builds them, then K6a."""
    packed, _, _ = _churn_general(smoke, dev)
    p = max(packed, key=lambda p: p[0].shape[2])
    return (*p[:8], p[8], p[8])


def _k1_against(smoke, parent: str) -> int:
    """K1 here against K1 at ``parent`` (see the module note)."""
    import numpy as np
    import torch

    from dvda_tpu_torch.kernels.build import kernel_library
    from dvda_tpu_torch.parallel.step import example_batch
    from dvda_tpu_torch.testutil import filter_inputs

    dev = torch.device("cuda", 0)
    fns = {"parent": _k1_parent(parent),
           "change": kernel_library().dvda_mlp_filter}
    b = example_batch(device=dev, **smoke.STEP)
    F, C, NB, S = b.residuals.shape

    def flat(x):
        return x.reshape((F * C,) + tuple(x.shape[2:])).contiguous()

    zeros = b.residuals.new_zeros((F * C, 8))
    shapes = [
        ("headline chunk", [torch.from_numpy(np.asarray(a)).to(dev) for a in
                            filter_inputs(0, 1536, 16, 40, states=True)]),
        ("step", [flat(b.residuals).permute(1, 2, 0).contiguous(),
                  *(flat(getattr(b, k)) for k in (
                      "rc_fir", "rc_iir", "shift", "quant", "iir_reset",
                      "iir_init", "block_len")), zeros, zeros]),
        ("churn substream", list(_churn_k1_args(smoke, dev)))]
    for label, args in shapes:
        calls = {k: _k1_launcher(fn, args) for k, fn in fns.items()}
        for call, _ in calls.values():
            call()
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(calls["parent"][1],
                                                     calls["change"][1]))
        if not same:
            print(f"K1 {label}: the parent's and the change's outputs "
                  "differ", flush=True)
            return 1
        ms = {k: [] for k in fns}
        for k in ("parent", "change", "change", "parent"):
            ms[k].append(smoke._times(calls[k][0], 50)[0])
        NB, S, B = args[0].shape
        print(f"K1 {label} [NB, S, B] = {NB, S, B}: parent "
              f"{ms['parent'][0]:.4f} / {ms['parent'][1]:.4f} ms, change "
              f"{ms['change'][0]:.4f} / {ms['change'][1]:.4f} ms on the card "
              f"(parent, change, change, parent; change "
              f"{min(ms['change']) * 1e6 / (NB * S):.1f} ns per dependent "
              f"step of {NB * S}); outputs equal", flush=True)
    return 0


def _alternate(smoke, calls: dict, order: tuple, reps: int = 50) -> dict:
    """Card ms of each of ``calls`` (name -> a call), in ``order``."""
    ms = {k: [] for k in calls}
    for k in order:
        ms[k].append(smoke._times(calls[k], reps)[0])
    return ms


def _cppm_disc(smoke, work: str):
    """The smoke's plaintext and encrypted three-track discs."""
    _, _, _, spec = smoke.phase_synth(work)
    plain, enc_path, _ = smoke.phase_synth_cppm(work, spec)
    return plain, enc_path


def _k7_against(smoke, parent: str) -> int:
    """K7 here against K7 at ``parent`` (see the module note)."""
    import ctypes
    import tempfile

    import torch

    from dvda_tpu_torch.container.aob import AOBReader
    from dvda_tpu_torch.cppm.decrypt import CppmDecryptor
    from dvda_tpu_torch.kernels.build import kernel_library
    from dvda_tpu_torch.ops.c2_decrypt import _sboxes

    p, i64 = ctypes.c_void_p, ctypes.c_int64
    args = [p, i64, ctypes.c_uint64, ctypes.c_int, p, p, p]
    fns = {"parent": _built_alone("k7_parent", parent, "c2_decrypt.cu",
                                  "dvda_c2_decrypt", args),
           "change": kernel_library().dvda_c2_decrypt}
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        _, enc_path = _cppm_disc(smoke, work)
        aob = AOBReader(enc_path, 1)
        total = aob.total_sectors
        batches = [("4,096-sector batch", aob.read_sectors(0, 4096).copy()),
                   ("284-sector tail batch",
                    aob.read_sectors(total - 284, 284).copy())]
    k_au = CppmDecryptor(smoke.MEDIA_KEY, smoke.ALBUM).k_au
    sbox, sbox_f = (t.data_ptr() for t in _sboxes(dev, torch.int32))
    stream = torch.cuda.current_stream().cuda_stream
    reps = 50
    for label, batch in batches:
        src = torch.from_numpy(batch).to(dev)
        n = src.shape[0]
        outs = {}
        for k, fn in fns.items():
            outs[k] = src.clone()
            rc = fn(outs[k].data_ptr(), n, k_au, 0, sbox, sbox_f, stream)
            if rc:
                raise RuntimeError(f"K7 {k}: CUDA error {rc}")
        torch.cuda.synchronize()
        if not all(torch.equal(o, outs["parent"]) for o in outs.values()):
            print(f"K7 {label}: the outputs differ", flush=True)
            return 1

        def timed(fn):
            # each call decrypts its own fresh copy: a decrypted sector is
            # no longer scrambled
            copies = src.unsqueeze(0).repeat(6 * reps + 3, 1, 1)
            it = iter(range(copies.shape[0]))

            def call():
                rc = fn(copies[next(it)].data_ptr(), n, k_au, 0, sbox,
                        sbox_f, stream)
                if rc:
                    raise RuntimeError(f"K7: CUDA error {rc}")
            return smoke._times(call, reps)[0]

        ms = {k: [] for k in fns}
        for k in ("parent", "change", "change", "parent"):
            ms[k].append(timed(fns[k]))
        print(f"K7 {label} ({n} sectors): " + "; ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in ms.items())
            + " on the card (parent, change, change, parent); outputs "
            "equal", flush=True)
    return 0


def _k8_against(smoke, parent: str) -> int:
    """K8 here against K8 at ``parent`` (see the module note)."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from dvda_tpu_torch.codecs.pcm import pcm_gather_indices
    from dvda_tpu_torch.kernels.build import kernel_library
    from dvda_tpu_torch.testutil import PcmTrackSpec, build_disc

    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {"parent": _built_alone("k8_parent", parent, "pcm_unpack.cu",
                                  "dvda_pcm_unpack",
                                  [p, ctypes.c_int64, i, i, i, i, p, p, p]),
           "change": kernel_library().dvda_pcm_unpack}
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        # the smoke's two PCM tracks alone (the same chunks as on its disc)
        layout = build_disc(os.path.join(work, "AUDIO_TS"),
                            [[PcmTrackSpec(**t) for t in smoke.PCM_TRACKS]])
        tracks = [smoke._pcm_track_chunks(layout, t) for t in (1, 2)]
    stream = torch.cuda.current_stream().cuda_stream
    for host_chunks, bits, ch in tracks:
        chunks = torch.from_numpy(host_chunks.copy()).to(dev)
        n, csize = chunks.shape
        table = np.ascontiguousarray(pcm_gather_indices(bits, ch), np.int32)
        for nbytes in (bits // 8, 0):
            calls, outs = {}, {}
            for k, fn in fns.items():
                outs[k] = torch.empty(n * 2 * ch * (nbytes or 4),
                                      dtype=torch.uint8, device=dev)

                def call(fn=fn, out=outs[k]):
                    rc = fn(chunks.data_ptr(), n, csize, ch, bits, nbytes,
                            table.ctypes.data, out.data_ptr(), stream)
                    if rc:
                        raise RuntimeError(f"K8: CUDA error {rc}")
                calls[k] = call
                call()
            torch.cuda.synchronize()
            if not torch.equal(outs["parent"], outs["change"]):
                print(f"K8 {ch} ch {bits}-bit nbytes={nbytes}: the outputs "
                      "differ", flush=True)
                return 1
            ms = _alternate(smoke, calls, ("parent", "change", "change",
                                           "parent"))
            print(f"K8 {ch} ch {bits}-bit track, {n} chunks, "
                  f"{'int32' if nbytes == 0 else f'packed {nbytes} bytes'}: "
                  f"parent {ms['parent'][0]:.4f} / {ms['parent'][1]:.4f} ms, "
                  f"change {ms['change'][0]:.4f} / {ms['change'][1]:.4f} ms "
                  "on the card (parent, change, change, parent); outputs "
                  "equal", flush=True)
    return 0


def _k234n_against(smoke, parent: str) -> int:
    """K234n (tiers 16 and 12) and K234 (wide, 24-bit) here against the
    parent's at the headline chunk (see the module note)."""
    import ctypes

    import numpy as np
    import torch

    from dvda_tpu_torch.kernels.build import kernel_library
    from dvda_tpu_torch.ops.rematrix import _narrow_scratch
    from dvda_tpu_torch.testutil import output_stage_inputs

    p, i = ctypes.c_void_p, ctypes.c_int
    lib = kernel_library()
    fns = {"narrow": {"parent": _built_alone(
        "k234n_parent", parent, "output_stage.cu",
        "dvda_output_stage_narrow", [p] * 13 + [i] * 7 + [p]),
        "change": lib.dvda_output_stage_narrow},
        "wide": {"parent": _built_alone(
            "k234_parent", parent, "output_stage.cu", "dvda_output_stage",
            [p] * 12 + [i] * 7 + [p]),
            "change": lib.dvda_output_stage}}
    dev = torch.device("cuda", 0)
    Bc, fpc, L0, C = 256, 8, 80, 6  # the smoke's headline chunk
    args = [torch.from_numpy(v).to(dev) for v in
            output_stage_inputs(1, Bc, fpc, L0, C, C, n_active=3).values()]
    ptrs = [a.data_ptr() for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    geom = (Bc, fpc, L0, C, C, 3)
    for label, kind, tier in (("K234n tier 16", "narrow", 16),
                              ("K234n tier 12", "narrow", 12),
                              ("K234 wide, 24-bit", "wide", 0)):
        row = C * 2 if tier == 16 else C // 2 * 3 if tier else C * 3
        calls, outs = {}, {}
        for who, fn in fns[kind].items():
            out = torch.empty((Bc * fpc * L0 + (8 if tier else 0), row),
                              dtype=torch.uint8, device=dev)
            outs[who] = out

            def call(fn=fn, out=out, who=who):
                if not tier:
                    rc = fn(*ptrs, out.data_ptr(), *geom, 3, stream)
                else:  # the parent zeroes a fresh word; the change keeps
                    # the stream's persistent pair at zero
                    word = (torch.empty(1, dtype=torch.int32, device=dev)
                            if who == "parent"
                            else _narrow_scratch(dev, stream))
                    rc = fn(*ptrs, out.data_ptr(), word.data_ptr(), *geom,
                            tier, stream)
                if rc:
                    raise RuntimeError(f"{label} {who}: CUDA error {rc}")
            calls[who] = call
            call()
        torch.cuda.synchronize()
        if not torch.equal(outs["parent"], outs["change"]):
            print(f"{label}: the outputs differ", flush=True)
            return 1
        flag = int(outs["change"][-1, -1]) if tier else None
        ms = _alternate(smoke, calls, ("parent", "change", "change",
                                       "parent"))
        print(f"{label}, headline chunk {Bc} chains x {fpc} x {L0}: parent "
              f"{ms['parent'][0]:.4f} / {ms['parent'][1]:.4f} ms, change "
              f"{ms['change'][0]:.4f} / {ms['change'][1]:.4f} ms on the card "
              f"(parent, change, change, parent); outputs equal"
              + (f", flag {flag}" if tier else ""), flush=True)
    return 0


def _k6b_against(smoke, parent: str) -> int:
    """K6b here against the parent's on the churn disc's K1 outputs (see
    the module note)."""
    import ctypes

    import torch

    from dvda_tpu_torch.kernels.build import kernel_library
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl

    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fns = {"parent": _built_alone("k6b_parent", parent, "general_gather.cu",
                                  "dvda_series_remix",
                                  [p, p, i, p, p, i] + [p] * 11
                                  + [i64, i, i, p]),
           "change": kernel_library().dvda_series_remix}
    dev = torch.device("cuda", 0)
    packed, subs, tabs = _churn_general(smoke, dev)
    outs = [(mlp_filter_blocks_tl(*q[:8], q[8], q[8])[0], u["series_idx"],
             u["shift"].shape[1]) for q, u in zip(packed, subs)]
    (o0, i0, n0), (o1, i1, n1) = (outs + [(outs[0][0], outs[0][1], 0)])[:2]
    T, F, C_out = tabs[1].shape[0], tabs[0].shape[0] - 1, tabs[-1].shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    calls, ys = {}, {}
    for who, fn in fns.items():
        y = torch.empty((T, C_out), dtype=torch.int32, device=dev)
        ys[who] = y

        def call(fn=fn, y=y):
            rc = fn(o0.data_ptr(), i0.data_ptr(), n0, o1.data_ptr(),
                    i1.data_ptr(), n1, *(t.data_ptr() for t in tabs),
                    y.data_ptr(), T, F, C_out, stream)
            if rc:
                raise RuntimeError(f"K6b: CUDA error {rc}")
        calls[who] = call
        call()
    torch.cuda.synchronize()
    if not torch.equal(ys["parent"], ys["change"]):
        print("K6b: the outputs differ", flush=True)
        return 1
    ms = _alternate(smoke, calls, ("parent", "change", "change", "parent"),
                    20)
    print(f"K6b churn disc, T={T} rows x {C_out} ch, {F} frames: parent "
          f"{ms['parent'][0]:.4f} / {ms['parent'][1]:.4f} ms, change "
          f"{ms['change'][0]:.4f} / {ms['change'][1]:.4f} ms on the card "
          "(parent, change, change, parent); outputs equal", flush=True)
    return 0


def _engine_k9_args(smoke, dev) -> tuple:
    """K9's arguments as the Python engine passes them on the smoke's 5 s
    engine disc (synthesised and decoded with ``use_native=False``: ~30 s
    of host): (positional arguments, n_mats)."""
    import tempfile

    from dvda_tpu_torch.codecs.mlp import engine
    from dvda_tpu_torch.config import DecodeConfig

    captured = []
    real = engine.frame_remix

    def capture(*args, **kw):
        captured.append((args, kw.get("n_mats", 6)))
        return real(*args, **kw)

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        layout = smoke.phase_synth_engine(work, smoke.ENGINE_FRAMES, "engine")
        engine.frame_remix = capture
        try:
            smoke._open_track(layout, DecodeConfig(
                device=str(dev), use_native=False)).read_all_packed()
        finally:
            engine.frame_remix = real
    (args, n_mats), = captured
    return list(args), n_mats


def _k9_against(smoke, parent: str) -> int:
    """K9 here against the parent's at the fused step's batch and on the
    engine disc's own inputs (see the module note)."""
    import ctypes

    import torch

    from dvda_tpu_torch.kernels.build import kernel_library
    from dvda_tpu_torch.parallel.step import _filtered, example_batch

    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {"parent": _built_alone("k9_parent", parent, "frame_remix.cu",
                                  "dvda_frame_remix",
                                  [p] * 10 + [i] * 5 + [ctypes.c_uint, p]),
           "change": kernel_library().dvda_frame_remix}
    dev = torch.device("cuda", 0)
    b = example_batch(device=dev, **smoke.STEP)
    channels = _filtered({k: getattr(b, k) for k in (
        "residuals", "rc_fir", "rc_iir", "shift", "quant", "iir_reset",
        "iir_init", "block_len")})
    step = ([channels, b.noise, b.mat_coeff, b.mat_noise, b.mat_out,
             b.mat_active, b.mat_quant, b.bypassed, b.output_shift,
             b.wave_perm], 6)
    stream = torch.cuda.current_stream().cuda_stream
    for label, (args, n_mats) in (("step batch", step),
                                  ("engine disc",
                                   _engine_k9_args(smoke, dev))):
        F, L, C = args[0].shape
        perm = [int(v) for v in torch.as_tensor(args[9]).tolist()]
        bits = sum(v << (4 * k) for k, v in enumerate(perm))
        ptrs = [a.data_ptr() for a in args[:9]]
        calls, outs = {}, {}
        for who, fn in fns.items():
            out = torch.empty((F, L, len(perm)), dtype=torch.int32,
                              device=dev)
            outs[who] = out

            def call(fn=fn, out=out):
                rc = fn(*ptrs, out.data_ptr(), F, L, C, len(perm), n_mats,
                        bits, stream)
                if rc:
                    raise RuntimeError(f"K9 {label}: CUDA error {rc}")
            calls[who] = call
            call()
        torch.cuda.synchronize()
        if not torch.equal(outs["parent"], outs["change"]):
            print(f"K9 {label}: the outputs differ", flush=True)
            return 1
        ms = _alternate(smoke, calls, ("parent", "change", "change",
                                       "parent"))
        print(f"K9 {label}, [F, L, C] = {F, L, C} -> {len(perm)} ch, "
              f"{n_mats} slots: parent {ms['parent'][0]:.4f} / "
              f"{ms['parent'][1]:.4f} ms, change {ms['change'][0]:.4f} / "
              f"{ms['change'][1]:.4f} ms on the card (parent, change, "
              "change, parent); outputs equal", flush=True)
    return 0


def _parent_engine(parent: str):
    """The chunk program module of the port in the checkout at
    ``parent``, its package imported as ``parent_dvda_tpu_torch``."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(parent), "dvda_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_dvda_tpu_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(
        "parent_dvda_tpu_torch.codecs.mlp.native_engine")


def _k10_alone(smoke, arenas, spec, words, huffman: bool) -> None:
    """K10 alone at the device-Huffman headline chunk (a standard chunk
    does not launch it)."""
    from dvda_tpu_torch.ops.chunk_lanes import (chunk_lanes,
                                                chunk_lanes_reference)

    if not huffman:
        return
    ms, ev = smoke._times(lambda: chunk_lanes(*arenas, spec), 50)
    plain = smoke.events_ms(lambda: chunk_lanes_reference(*arenas, spec), 5)
    print(f"K10 chunk_lanes, headline chunk (device Huffman): {ms:.4f} ms "
          f"on the card ({ev:.4f} ms per call back to back), plain "
          f"{plain:.3f} ms", flush=True)


def _k1a_alone(smoke, arenas, spec, words, huffman: bool) -> None:
    """K1a alone at the headline chunk; in device Huffman K10 alone, then
    K1a on the residuals K5 writes."""
    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.ops.chunk_filter import (chunk_filter,
                                                 chunk_filter_reference)
    from dvda_tpu_torch.ops.chunk_lanes import (chunk_lanes,
                                                chunk_lanes_reference)
    from dvda_tpu_torch.ops.huffman_decode import decode_residuals_device
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl

    mode = "device Huffman" if huffman else "standard"
    res = None
    if huffman:
        _k10_alone(smoke, arenas, spec, words, huffman)
        lanes = chunk_lanes(*arenas, spec)
        arrs, flags = ne.unpack_spec(*arenas, spec)
        for i, (g, lane0) in enumerate(lanes.places):
            args, kw = ne.huffman_inputs(lanes, arrs, flags, i, words)
            decode_residuals_device(*args, **kw, out=lanes.residuals[g],
                                    lane0=lane0)
        res = lanes.residuals
    ms, ev = smoke._times(lambda: chunk_filter(*arenas, spec, res), 50)
    plain = smoke.events_ms(
        lambda: chunk_filter_reference(*arenas, spec, res), 2)
    # K1 on the same chunk: the plain front end's filter inputs (K5's
    # residuals in device Huffman)
    args = chunk_lanes_reference(*arenas, spec).filters[0]
    args = (res[0] if huffman else args[0],) + tuple(args[1:])
    k1, _ = smoke._times(lambda: mlp_filter_blocks_tl(*args), 50)
    print(f"K1a mlp_filter_arena, headline chunk ({mode}): {ms:.4f} ms on "
          f"the card ({ev:.4f} ms per call back to back), plain "
          f"{plain:.2f} ms; K1 on the front end's inputs of the same chunk "
          f"{k1:.4f} ms", flush=True)


def _chunk_program_against(smoke, parent: str, alone) -> int:
    """``alone`` at the headline chunk, then the chunk program here
    against the chunk program at ``parent``, both modes (see the module
    note)."""
    import torch

    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.testutil import MlpSynthConfig, synth_mlp_stream

    dev = torch.device("cuda", 0)
    cfg = MlpSynthConfig(**dict(smoke.HEADLINE,
                                n_frames=8 * smoke.CHUNK + 8))
    stream = synth_mlp_stream(cfg)
    parent_ne = _parent_engine(parent)
    for huffman in (False, True):
        mode = "device Huffman" if huffman else "standard"
        arenas, spec, words = smoke._headline_chunk(stream, dev, huffman)
        alone(smoke, arenas, spec, words, huffman)
        calls = {"parent": lambda: parent_ne.uniform_arena_pipeline(
                     *arenas, spec, words),
                 "change": lambda: ne.uniform_arena_pipeline(
                     *arenas, spec, words)}
        outs = {k: fn() for k, fn in calls.items()}
        torch.cuda.synchronize()
        if not torch.equal(outs["parent"], outs["change"]):
            print(f"chunk program ({mode}): the parent's and the change's "
                  "outputs differ", flush=True)
            return 1
        ms = {k: [] for k in calls}
        for k in ("parent", "change", "change", "parent"):
            ms[k].append(smoke._times(calls[k], 10))
        card = {k: " / ".join(f"{c:.4f}" for c, _ in v)
                for k, v in ms.items()}
        ev = {k: " / ".join(f"{e:.4f}" for _, e in v) for k, v in ms.items()}
        print(f"chunk program, headline chunk ({mode}): parent "
              f"{card['parent']} ms, change {card['change']} ms on the card; "
              f"per call back to back parent {ev['parent']} ms, change "
              f"{ev['change']} ms (parent, change, change, parent); outputs "
              "equal", flush=True)
    return 0


def _k10_against(smoke, parent: str) -> int:
    return _chunk_program_against(smoke, parent, _k10_alone)


def _k1a_against(smoke, parent: str) -> int:
    return _chunk_program_against(smoke, parent, _k1a_alone)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_timing_check: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    if sys.argv[1:] == ["chains"]:
        smoke.phase_device()
        return _chains(smoke)
    against = {"k1": _k1_against, "k7": _k7_against, "k8": _k8_against,
               "k234n": _k234n_against, "k6b": _k6b_against,
               "k9": _k9_against, "k10": _k10_against,
               "k1a": _k1a_against}
    if sys.argv[1:2] and sys.argv[1] in against and len(sys.argv) == 3:
        smoke.phase_device()
        return against[sys.argv[1]](smoke, sys.argv[2])
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

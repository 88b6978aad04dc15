#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dvda_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure propagates (non-zero exit):

1. device: the card's name and power limit (fails without CUDA);
2. build: the CUDA kernels from dvda_tpu_torch/csrc with nvcc (sm_90a),
   one nvcc per source, all started together; ptxas's registers, shared
   memory and stack per kernel (a stack frame in any kernel fails);
3. synthesis: a 30-second 5.1/96k/24 MLP disc, and a three-track
   CPPM-encrypted disc — that MLP stream, 30 s of PCM 5.1/96k/24 and 30 s
   of PCM 2.0/48k/16 — with a plaintext copy; and an 8-second loud
   2.0/192k/24 MLP disc (the benchmark's ``mlp20_192k24``);
4. kernels: each kernel against its plain PyTorch version on the card,
   bit-exact (tolerance 0: the decode is integer arithmetic), at the shapes
   the main paths give it (K1 also on lane-leading residuals, writing
   lane-leading output and the step's frame-major channels, at
   ``FILTER_EDGES``, and each layout timed at the step batch beside the
   time-leading one; K1, K234 and K5 also at the edge shapes of
   ``testutil.FILTER_EDGES``, ``OUTPUT_STAGE_EDGES`` and
   ``HUFFMAN_EDGES``, K7 at ``C2_EDGES``, K8 at ``PCM_EDGES``, K9 at
   ``FRAME_REMIX_EDGES``, K10, a device-Huffman chunk's K5 inputs, and
   K1a, the filter reading the chunk arenas (in device Huffman on the
   residuals K10 and K5 write), at the headline chunk (K1a in both
   modes) and at ``CHUNK_LANES_EDGES``; K5
   also into the fused filter input, each substream at its lanes;
   K234n, the narrow readback, at tiers 12 and 16 with
   its flag rows, at the headline chunk, at ``NARROW_EDGES`` and with
   samples at the tiers' ends, ``NARROW_RANGES``, so that its flag takes
   each of 0-3, and twice in a row on one stream, a chunk that misses both
   tiers and then one that fits both, whose flag must be its own: the one
   launch resets its scratch) — K5's inputs come from the
   skip-values parse of the disc's first chunk, K8's from the PCM track's
   chunks, K7's from the encrypted disc's first AOB batch.  A kernel's
   time is its time on the card: CUDA events around calls the host has
   all queued while the card waits in a spin kernel
   (``utils.profiling.device_ms``).  Beside it is the CUDA-event time of
   calls made back to back (``utils.profiling.events_ms``), which also
   holds the wrapper's host time where that is longer; the plain
   versions' times are of the latter kind.  K1, K5 and K7, bound by
   their serial chains, also print their card time per dependent step
   (per sample of a lane, per symbol of a sub-lane, per word of a sector)
   and K5 its staged stream windows;
5. MLP path, in both modes: the MLP disc decoded through
   ``open_disc(...)...read_all_packed()`` on the card in standard mode and
   in device-Huffman mode, each with the narrow readback on (the default)
   and off, each byte-compared with the port's C++ host-complete
   reconstruction of the same stream; the launch counters, zeroed before
   each decode, must show that it went through its kernels (K1a once a
   chunk, and K234n with narrow on or K234 with it off; in
   device-Huffman mode K10 once and K5 twice a chunk too; K1 never, and
   K10 never in standard mode); the
   tier each decode settled at, the chunks run again and the bytes
   drained; walls from the assembled stream, narrow on and off
   alternating, best of 5; then ``iter_packed`` at the default segment
   (the whole 30 s track) and at 5 s segments (6 chunks, each a
   ``decode_native`` of one slice between resume points), whose chunks
   must join to the ``read_all_packed()`` bytes, with K1a and K234n
   launched for each;
5a. profile: one ``uniform_arena_pipeline`` call on the headline's first
   chunk, arenas on the card, under ``torch.profiler`` in each mode: its
   card records must be the port's kernels only (K1a, K234n; K10 and
   K5 in device Huffman), no other kernel, copy or fill; then one whole
   standard decode's records and idle share, printed;
5b. unfused: a hand-built headline-sized chunk whose two substreams
   differ in block geometry (``testutil.unfused_chunk_inputs``) through
   ``uniform_arena_pipeline`` on the card: two K1a launches, each writing
   its lanes at their columns of the one series K234 reads, equal to the
   plain chunk program; under the profiler 2 x K1a + K234 records only;
5c. modes: the headline's first and last (partial) chunk built by
   ``mp_pack`` and by the numpy arena builder, pinned, in both modes:
   byte-equal arenas, equal specs; then the disc through
   ``read_all_packed()`` with ``native_pack=False`` (both modes), with the
   chunks round-robin over ``[cuda:0, cuda:0]`` (both modes) and with
   ``multi_device`` over every visible card, and with
   ``drain_thread=False`` at narrow tier 16 and with the narrow readback
   off (both modes): each equal to host-complete, with K1a and K234n
   (K234 with narrow off; K10 and K5 in device Huffman) launched for
   every chunk;
   and
   ``decode_native`` with each builder, best of 3 alternating, with the
   ``mlp/arena-build`` stage of each;
5d. stereo 192k: the 2.0/192k disc's first chunk (768 chains, one
   substream of 16 blocks x 80 samples, one 12-bit channel pair) through
   the main path's chunk program and its redo at tiers 16 and 0, K1a and
   each output stage call == its plain version on the same inputs, one
   launch each, the chunk overflowing the 12-bit tier, with K1a's and
   K234n's card times; then the disc through ``read_all_packed()`` in
   both modes, narrow on and off, with ``native_pack=False`` and
   ``drain_thread=False``: each == host-complete, pipelined in one
   section, K1a and K234 once a chunk, K234n once per chunk run again,
   and ``decode_native.mlp_chunks_redone``, zeroed with the launch
   counters, equal to the decode's ``info["redone"]``;
6. PCM + CPPM path: each track of the encrypted disc through a decrypting
   ``AOBReader`` and the port's ``TrackReader(...).read_all_packed()``,
   and the plaintext copy through ``dvda_tpu_torch.batch.disc_to_wavs``,
   byte-compared with the port's C++ host path (the packet walk +
   ``pcm_repack`` for PCM, host-complete for MLP), and each PCM track
   once more through ``read_all()`` (int32); the counters, zeroed before
   the phase, must show K7, K8, K1a and K234n launches, every packed PCM
   decode read back into the walk's pinned buffer and every int32 one
   into pageable memory; walls against the host path (host C2);
6b. tiers: the three short 24-bit streams of
   tests/test_mlp_native.py:728-765 (quiet, mid, loud) with narrow on and
   off in both modes, equal to host-complete; they settle at tiers 12, 16
   and 0;
7. general path: a 30-second 5.1/96k/24 MLP disc of 12 sections that
   alternate 2 x 40 and 4 x 20 samples per frame, which the pipelined
   driver abandons: K6a and K6b against their plain versions at its
   shapes (K6a also at ``testutil.LANE_PACK_EDGES``, K6b at
   ``SERIES_REMIX_EDGES``; K1 timed at its
   widest substream), then the disc
   through ``open_disc(...).read_all_packed()``,
   which must take the general path (K6a, K1, K6b launched) and equal the
   host-complete bytes; walls against host-complete;
8. fused decode step: ``parallel.step.decode_step`` on
   ``example_batch(F=256, C=8, NB=16, S=40)`` on the card (one K1 and one
   K9 launch), bit-exact against the same step built from the plain
   versions on the card; ``make_sharded_step`` over ``make_mesh()`` (every
   visible card) equal to it; one step under the profiler, whose card
   records must be one K1 and one K9 (no copy, fill or other kernel),
   equal to the counters; the step's CUDA-event and card time, and K1's
   card time at the step's lanes, time-leading and frame-major (the
   step's own);
9. Python engine: a 5-second 5.1/96k/24 disc (6,000 frames: the pure-Python
   planner costs seconds of host time per second of audio) through
   ``open_disc(...).read_all_packed()`` with ``use_native=False``: the
   batched engine path, K1 and K9 launched, bytes equal to host-complete;
   K9 against its plain version at the engine's own inputs; the engine's
   filter call on its own inputs under the profiler: host-to-device
   copies of its eight lane arrays and one K1, nothing else; walls and the
   planner / filter / frames stages;
10. bail: a 1-second 5.1/96k/24 disc without check data whose frame 8 is
   damaged: the native parser bails (logged), the planner bails too, and
   the track decodes on the spec path, byte-equal to the port's
   ``MlpDecoder`` run on the assembled stream.
11. surface: the headline disc through the C-style API (``dvda_open`` ...
   ``dvda_read`` in reads of 4,096 frames on the default device) equal to
   ``read_all()``, with K1a and K234n launched; the encrypted disc through
   ``SourceAOBReader([CallableSectorSource(...)], decrypt=<the port's
   CppmDecryptor>)``, equal to the host path on the plaintext copy, with
   K7, K8, K1a and K234n launched (the counters zeroed before each part);
   ``dvda_debug_info`` on the plaintext disc, one row per track with the
   ``Track`` objects' sectors; ``dvda-huffman --format json`` on codebook
   2 equal to ``peek_lut(2)``.

The gated captures of 5b, 8 and 9 each run in a child process of their
own (``chip_smoke.py --records step|unfused|engine``): this card's
profiler loses the records of short captures once a process has gone
30 s without one, and once lost one of two K1a records in every capture
of a fresh child; a child whose captures lost records of the port's
kernels, and held nothing else, is run again (at most three children).

Every kernel's record carries its bound: the larger of the bytes it must
move (each input byte it needs read once, each output written once) over
3.35 TB/s and its integer operations over 67 T/s (the H100's CUDA-core
float32 rate, the only non-tensor-core rate the data sheet gives; it
overstates the integer rate, so the operations side is a lower bound on
time and ``bound_by`` leans to bytes), computed from this run's inputs,
and ``library_ms``: the time of the one PyTorch call
that computes the same function where there is one (K8's packed form:
``index_select`` by the gather table; K6a's residual gather:
``torch.take``), timed here only.  K1a's ``launches`` sums its launches
over every uniform MLP path's run (standard and device Huffman, each
with narrow on and off, ``iter_packed`` at 5 s segments, the unfused
chunk, the modes of 5c, the CPPM track), K1's over the paths that still
run it (churn, step, engine); K10's the two device-Huffman headline decodes of
phase 5.  The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

# the port's card timers (tools/torch_timing_check.py uses them too); the
# import fails outside a checkout, as the script must
from dvda_tpu_torch.utils.profiling import device_ms, events_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
# the bench headline (mlp_51_96k): 5.1 in 2 substreams, 96 kHz / 24-bit,
# 2 blocks x 40 samples per frame, restart + major sync every 8 frames
HEADLINE = dict(channel_assignment=17, substream_count=2, bits_per_sample=24,
                sample_rate=96000, n_frames=36000, blocks_per_frame=2,
                block_size=40, major_sync_every=8, restart_every=8, seed=7,
                fir_across_restart=False, params_update_prob=0.0)
SECONDS = 30
#: the stereo 192k disc (the benchmark's mlp20_192k24, 8 s): 2 ch in one
#: substream, 192 kHz / 24-bit, 2 blocks x 80 samples per frame, restart
#: + major sync every 8 frames (1,280-sample chains), output shifts past
#: the 12-bit pair tier and int16, so the narrow readback runs its first
#: chunks again and settles wide
STEREO = dict(channel_assignment=1, substream_count=1, bits_per_sample=24,
              sample_rate=192000, n_frames=9600, blocks_per_frame=2,
              block_size=80, major_sync_every=8, restart_every=8, seed=13,
              fir_across_restart=False, params_update_prob=0.3,
              out_shift_range=(6, 8))
#: its chunk: 768 chains (the chunk rule at 2 channels: 256 x 6 / 2
#: chains, of 1,280 samples each, so twice the 5.1 headline chunk's
#: samples)
STEREO_CHUNK = 768
#: headline chunk geometry: 256 chains of 16 blocks x 40 samples,
#: 8 frames of 80 samples per chain
CHUNK, NB0, S0, L0 = 256, 16, 40, 80
KERNELS = ("mlp_filter_arena", "chunk_lanes", "mlp_filter", "output_stage",
           "output_stage_narrow", "huffman_decode", "pcm_unpack",
           "c2_decrypt", "lane_pack", "series_remix", "frame_remix")
#: kernels whose build fails if ptxas gives them a stack frame (K234n is
#: one launch of K234's kernel, ``output_stage``)
NO_STACK = ("output_stage", "lane_pack", "series_remix", "mlp_filter",
            "huffman_decode", "c2_decrypt", "pcm_unpack", "frame_remix",
            "chunk_lanes", "mlp_filter_arena")
#: the three-tier streams (tests/test_mlp_native.py:728-765): 5.1, 24
#: frames, seed 11, output shifts putting the peak within 12 bits, within
#: int16, past int16; and the tier each must settle at
TIER_STREAMS = {"quiet": ((0, 1), 12), "mid": ((5, 6), 16),
                "loud": ((7, 8), 0)}
#: the fused decode step's batch: __graft_entry__'s production shape
STEP = dict(F=256, C=8, NB=16, S=40, C_out=6, seed=0)
#: the Python-engine disc (5 s) and the bail disc (1 s), headline format
ENGINE_FRAMES, BAIL_FRAMES = 6000, 1200
#: the device of the step, engine and bail phases
DEV = "cuda"
#: the smoke's discs and files, removed at its end; the engine's filter
#: inputs, saved for the ``--records engine`` child
WORK = os.path.join(ROOT, "build", "chip_smoke")
ENGINE_FILTER = os.path.join(WORK, "engine_filter.npz")
#: the general-path disc: 12 sections of 2.5 s, alternating the geometry
GENERAL = dict(channel_assignment=17, substream_count=2, bits_per_sample=24,
               sample_rate=96000, n_frames=3000, major_sync_every=8,
               restart_every=8, fir_across_restart=False,
               params_update_prob=0.0)
SECTIONS = 12
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, CUDA-core ops/s
HBM_BPS, CORE_OPS = 3.35e12, 67e12
#: the encrypted disc's PCM tracks (the JAX bench's pcm_hires-style
#: 5.1/96k/24 and its pcm_2ch_48k), and its CPPM keys (bench.py:425)
PCM_TRACKS = (dict(pcm_frames=2_880_000, sample_rate=96000,
                   bits_per_sample=24, channel_assignment=17, seed=4),
              dict(pcm_frames=1_440_000, sample_rate=48000,
                   bits_per_sample=16, channel_assignment=1, seed=1))
MEDIA_KEY, ALBUM = 0x00DEADBEEF001122, 0x0F0E0D0C0B0A0908
#: K1 launches of each main path's run (the filter of the general path,
#: the fused step and the Python engine), and K1a's (the filter of every
#: uniform chunk: the headline decodes, iter_packed, the modes of 5c, the
#: CPPM disc's MLP track)
K1_PATHS: dict[str, int] = {}
K1A_PATHS: dict[str, int] = {}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name!r} count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from dvda_tpu_torch.codecs.mlp import native_engine
    from dvda_tpu_torch.kernels.build import build_kernels, kernel_library

    seconds, log = build_kernels(verbose=True)
    kernel_library()
    print(f"[build] nvcc sm_90a: {seconds:.2f} s")
    kernel, stack = "?", {}
    for line in log.splitlines():  # ptxas: registers, stack, spills
        named = [k for k in KERNELS if f"{k}_kernel" in line]
        if "Compiling entry function" in line and named:
            kernel = named[0]
        elif "Used" in line or "spill" in line:
            print(f"[build] {kernel}: {line.split(':', 1)[-1].strip()}")
            if "stack frame" in line:  # every instantiation of a template
                stack[kernel] = max(stack.get(kernel, 0),
                                    int(line.split()[0]))
    # the tiled designs keep their tables in shared memory or registers,
    # not on a stack
    for k in NO_STACK:
        _require(stack.get(k) == 0, f"ptxas: {k} has a stack frame of "
                                    f"{stack.get(k)} bytes")
    # the port's C++ host runtime (parse, mp_pack) builds with g++ at first
    # use: do it here, outside the timed decodes
    t0 = time.perf_counter()
    _require(native_engine.host.available(),
             "the port's C++ host runtime did not build")
    print(f"[build] host runtime ready: {time.perf_counter() - t0:.2f} s")


def _times(fn, reps: int) -> tuple[float, float]:
    """(card ms with every call queued ahead, ms per call back to back
    by CUDA events) for ``fn``, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    return device_ms(fn, reps), events_ms(fn, reps)


def _record(err: int, ms: float, plain_ms: float, nbytes: int, ops: int,
            library_ms: float | None = None) -> dict:
    """A kernel's measured numbers and its bound: the larger of ``nbytes``
    over the HBM rate and ``ops`` over the CUDA-core rate."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / CORE_OPS
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def _nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (other arguments are skipped)."""
    import torch

    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _max_err(a, b) -> int:
    import torch

    _require(a.shape == b.shape and a.dtype == b.dtype,
             f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def phase_synth(work: str):
    """The 30-second MLP disc: (layout, stream, synth config, track spec)."""
    from dvda_tpu_torch.testutil import (MlpSynthConfig, MlpTrackSpec,
                                         build_disc, synth_mlp_stream)

    t0 = time.perf_counter()
    cfg = MlpSynthConfig(**HEADLINE)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                        pcm_frames=cfg.total_pcm_frames,
                        sample_rate=cfg.sample_rate,
                        channel_assignment=cfg.channel_assignment)
    layout = build_disc(os.path.join(work, "AUDIO_TS"), [[spec]])
    print(f"[synth] {SECONDS} s 5.1/96k/24 disc: "
          f"{len(spec.mlp_stream) / 1e6:.2f} MB MLP stream in "
          f"{time.perf_counter() - t0:.1f} s")
    return layout, spec.mlp_stream, cfg, spec


def phase_synth_stereo(work: str):
    """The 8-second stereo 192k disc: its layout."""
    from dvda_tpu_torch.testutil import (MlpSynthConfig, MlpTrackSpec,
                                         build_disc, synth_mlp_stream)

    t0 = time.perf_counter()
    cfg = MlpSynthConfig(**STEREO)
    spec = MlpTrackSpec(mlp_stream=synth_mlp_stream(cfg),
                        pcm_frames=cfg.total_pcm_frames,
                        sample_rate=cfg.sample_rate,
                        channel_assignment=cfg.channel_assignment)
    layout = build_disc(os.path.join(work, "STEREO", "AUDIO_TS"), [[spec]])
    print(f"[synth] {cfg.total_pcm_frames / cfg.sample_rate:.0f} s "
          f"2.0/192k/24 disc: {len(spec.mlp_stream) / 1e6:.2f} MB MLP "
          f"stream in {time.perf_counter() - t0:.1f} s")
    return layout


def phase_synth_cppm(work: str, mlp_spec):
    """The encrypted three-track disc and its plaintext copy: (plaintext
    layout, encrypted AUDIO_TS path, sector count)."""
    import numpy as np

    from dvda_tpu_torch.testutil import (PcmTrackSpec, build_disc,
                                         encrypt_sectors_batch)

    t0 = time.perf_counter()
    plain = build_disc(os.path.join(work, "plain", "AUDIO_TS"),
                       [[mlp_spec] + [PcmTrackSpec(**t) for t in
                                      PCM_TRACKS]])
    enc_path = os.path.join(work, "cppm", "AUDIO_TS")
    shutil.copytree(plain.path, enc_path)
    aob = os.path.join(enc_path, "ATS_01_1.AOB")
    raw = np.fromfile(aob, dtype=np.uint8).reshape(-1, 2048)
    t1 = time.perf_counter()
    enc = encrypt_sectors_batch(raw, MEDIA_KEY, ALBUM)
    _require(int((enc != raw).any(1).sum()) > 0.99 * raw.shape[0],
             "the encryptor left the disc's sectors as they were")
    enc.tofile(aob)
    print(f"[synth] CPPM disc (MLP 5.1/96k/24 + PCM 5.1/96k/24 + PCM "
          f"2.0/48k/16, {SECONDS} s each): {raw.shape[0]} sectors, "
          f"{raw.nbytes / 1e6:.1f} MB, encrypted in {time.perf_counter() - t1:.1f}"
          f" s ({time.perf_counter() - t0:.1f} s with the plaintext disc)")
    return plain, enc_path, raw.shape[0]


def _headline_chunk(stream, dev, huffman: bool):
    """The disc's first chunk as the main path builds it (the parse of its
    frames, in skip-values mode for device Huffman; ``mp_pack``; 24-bit
    pack, narrow readback at tier 16), its arenas on the card: (arenas,
    spec, the track's words on the card or None)."""
    from dvda_tpu_torch.codecs.mlp import native_engine as ne

    inc = ne.host.parse_mlp_stream_begin(stream, skip_values=huffman)
    try:
        inc.step(8 * CHUNK + 8)  # the first chunk's frames (8 per chain)
        v = inc.view()
        _require(v.status == 0 and v.substream_count == 2,
                 "parse of the headline failed")
        subs = [(v.sub[s], 0, S0, NB0, 0) for s in range(2)]
        arenas, spec = ne._build_chunk_arenas(
            v, subs, 0, CHUNK, CHUNK, NB0 * S0, L0, 6, 24, 0, 0, 6,
            huffman=huffman, narrow=16)
    finally:
        inc.close()
    words = ne._shared_words(stream, dev) if huffman else None
    return ne.arenas_to_device(*arenas, spec, dev), spec, words


def _huffman_headline(stream, dev):
    """K5's arguments for both substreams of the disc's first chunk, as the
    device-Huffman main path builds them (K10's lane inputs, here from its
    plain version on the card), and that chunk's lanes (for the fused
    filter input the main path has K5 write)."""
    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.ops.chunk_lanes import chunk_lanes_reference

    arenas, spec, words = _headline_chunk(stream, dev, True)
    arrs, flags = ne.unpack_spec(*arenas, spec)
    lanes = chunk_lanes_reference(*arenas, spec)
    return [ne.huffman_inputs(lanes, arrs, flags, i, words)
            for i in range(2)], lanes


def _spec_bytes(spec, names=None) -> int:
    """Bytes of the substream arrays of ``spec`` (of ``names`` only, by
    their suffix after ``sN_``, where given); K5's bypass slot map is
    not an input of K10 or K1a."""
    import numpy as np

    return sum(int(np.prod(e[3])) * e[1] for e in spec
               if e[4] != "flag" and e[0][0] == "s" and e[0][1].isdigit()
               and not e[0].endswith(("_bypk", "_bypv"))
               and (names is None or e[0].split("_", 1)[1] in names))


def _kernel_k10(stream, dev):
    """K10 (a device-Huffman chunk's K5 lane inputs and residual buffers)
    against the plain front end on the card, bit-exact: the headline's
    first chunk in device-Huffman mode, then the device-Huffman cases of
    ``testutil.CHUNK_LANES_EDGES`` (fused and unfused substreams,
    per-chain and per-block rows); its card time at the headline chunk."""
    import torch

    from dvda_tpu_torch.ops.chunk_lanes import (chunk_lanes,
                                                chunk_lanes_reference)
    from dvda_tpu_torch.testutil import CHUNK_LANES_EDGES, chunk_lanes_inputs

    def check(arenas, spec, label):
        got = chunk_lanes(*arenas, spec)
        ref = chunk_lanes_reference(*arenas, spec)
        torch.cuda.synchronize()
        err = 0
        for mine, theirs in zip(got.huffman, ref.huffman, strict=True):
            for m, t in zip(mine, theirs, strict=True):
                err = max(err, _max_err(m, t))
        _require([r.shape for r in got.residuals]
                 == [f[0].shape for f in ref.filters],
                 f"K10 {label}: residual buffers of the wrong shape")
        _require(err == 0, f"K10 {label}: max |kernel - plain| = {err}")
        return got, err

    arenas, spec, _ = _headline_chunk(stream, dev, True)
    got, k10_err = check(arenas, spec, "headline")
    print(f"[kernels] K10 chunk_lanes headline chunk (device Huffman): K5 "
          f"inputs of {len(got.huffman)} substreams, residual buffers "
          f"{[tuple(r.shape) for r in got.residuals]}: bit-exact")
    ms, ev = _times(lambda: chunk_lanes(*arenas, spec), 50)
    plain_ms = events_ms(lambda: chunk_lanes_reference(*arenas, spec), 5)
    # each array K10 reads once, each output once (K5's inputs; the
    # residual buffers are only allocated); about 4 integer operations an
    # output
    read = _spec_bytes(spec, ("bitpos", "cb", "lsbb", "off", "nbyp",
                              "quant", "quant_c"))
    written = sum(_nbytes(*h) for h in got.huffman)
    record = _record(0, ms, plain_ms, read + written, written)
    print(f"[kernels] K10 headline (device Huffman): kernel {ms:.4f} ms on "
          f"the card ({ev:.4f} ms per call back to back), bound "
          f"{record['bound_ms']:.4f} ms ({(read + written) / 1e6:.3f} MB: "
          f"{read / 1e6:.3f} read, {written / 1e6:.3f} written), plain "
          f"{plain_ms:.3f} ms per call")
    cases = [c for c in CHUNK_LANES_EDGES if c[4]]
    for case in cases:
        arenas, spec = chunk_lanes_inputs(case)
        arenas = [torch.from_numpy(a).to(dev) for a in arenas]
        _, err = check(arenas, spec, case[0])
        k10_err = max(k10_err, err)
    print(f"[kernels] K10 edge cases ({', '.join(c[0] for c in cases)}): "
          "bit-exact")
    record["max_abs_err"] = k10_err
    return record


def _kernel_k1a(stream, dev):
    """K1a (the filter reading the chunk arenas) against its plain version
    (the front end's, then K1's) on the card, bit-exact: the headline's
    first chunk in standard mode and in device Huffman (its residuals
    written by K10 and K5 as the main path writes them), then
    ``CHUNK_LANES_EDGES`` (device-Huffman cases on random residual
    buffers); its card time in both modes at the headline chunk, the
    record's that of standard mode."""
    import torch

    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.ops.chunk_filter import (chunk_filter,
                                                 chunk_filter_reference)
    from dvda_tpu_torch.ops.chunk_lanes import chunk_lanes, chunk_layout
    from dvda_tpu_torch.ops.huffman_decode import decode_residuals_device
    from dvda_tpu_torch.testutil import CHUNK_LANES_EDGES, chunk_lanes_inputs

    def check(arenas, spec, res, label):
        got = chunk_filter(*arenas, spec, res)
        ref = chunk_filter_reference(*arenas, spec, res)
        torch.cuda.synchronize()
        err = _max_err(got, ref)
        _require(err == 0, f"K1a {label}: max |kernel - plain| = {err}")
        return got, err

    k1a_err = 0
    for huffman in (False, True):
        mode = "device Huffman" if huffman else "standard"
        arenas, spec, words = _headline_chunk(stream, dev, huffman)
        res = None
        if huffman:  # the main path's residuals: K10, then K5
            lanes = chunk_lanes(*arenas, spec)
            arrs, flags = ne.unpack_spec(*arenas, spec)
            for i, (g, lane0) in enumerate(lanes.places):
                args, kw = ne.huffman_inputs(lanes, arrs, flags, i, words)
                decode_residuals_device(*args, **kw, out=lanes.residuals[g],
                                        lane0=lane0)
            res = lanes.residuals
        got, err = check(arenas, spec, res, f"headline ({mode})")
        k1a_err = max(k1a_err, err)
        ms, ev = _times(lambda: chunk_filter(*arenas, spec, res), 50)
        plain_ms = events_ms(
            lambda: chunk_filter_reference(*arenas, spec, res), 2)
        # each arena array it reads once (K5's residual buffer in device
        # Huffman), its output once; per sample 8 FIR + 8 IIR int64
        # multiply-adds, the shift, the quant mask and the residual add
        read = _spec_bytes(spec, ("res", "rc_fir", "rc_fir_c", "rc_iir",
                                  "rc_iir_c", "iir_init", "iir_init_c",
                                  "shift", "shift_c", "quant", "quant_c",
                                  "iir_reset", "iir_reset_c"))
        read += _nbytes(*(res or ()))
        written = _nbytes(got)
        cost = _record(0, ms, plain_ms, read + written, 36 * got.numel())
        NB, S = chunk_layout(spec).groups[0][:2]
        steps = NB * S
        print(f"[kernels] K1a mlp_filter_arena headline chunk ({mode}, "
              f"output {tuple(got.shape)}): bit-exact; kernel "
              f"{ms:.4f} ms on the card ({ev:.4f} ms per call back to back; "
              f"{ms * 1e6 / steps:.1f} ns per dependent step of {steps}), "
              f"bound {cost['bound_ms']:.4f} ms ({(read + written) / 1e6:.3f}"
              f" MB: {read / 1e6:.3f} read, {written / 1e6:.3f} written), "
              f"plain {plain_ms:.2f} ms per call")
        if not huffman:
            record = cost
    gen = torch.Generator().manual_seed(15)
    for case in CHUNK_LANES_EDGES:
        arenas, spec = chunk_lanes_inputs(case, filter_domain=True)
        arenas = [torch.from_numpy(a).to(dev) for a in arenas]
        res = None
        if case[4]:
            res = [torch.randint(-2**31, 2**31 - 1, g[:3], generator=gen,
                                 dtype=torch.int32).to(dev)
                   for g in chunk_layout(spec).groups]
        _, err = check(arenas, spec, res, case[0])
        k1a_err = max(k1a_err, err)
    print(f"[kernels] K1a edge cases "
          f"({', '.join(c[0] for c in CHUNK_LANES_EDGES)}): bit-exact")
    record["max_abs_err"] = k1a_err
    return record


def _kernel_k1_layouts(dev) -> dict:
    """K1 on lane-leading residuals (staged in place), writing lane-leading
    output (``mlp_filter_blocks``, the engine's entry) or the frame-major
    channels (``mlp_filter_frames``, the step's: zero states, no final
    states), against the plain version behind permutes, bit-exact, at
    ``FILTER_EDGES`` (null initial states where a case has none); then
    each layout's card time at the step batch beside the time-leading
    K1's, on the same inputs.  Returns the card times."""
    import numpy as np
    import torch

    from dvda_tpu_torch.ops.mlp_filter import (mlp_filter_blocks,
                                               mlp_filter_blocks_tl,
                                               mlp_filter_blocks_tl_reference,
                                               mlp_filter_frames)
    from dvda_tpu_torch.parallel.step import example_batch
    from dvda_tpu_torch.testutil import (FILTER_EDGES, filter_inputs,
                                         frame_channels)

    for B, NB, S, extreme, states in FILTER_EDGES:
        args = [torch.from_numpy(np.asarray(x)).to(dev) for x in
                filter_inputs(B + S, B, NB, S, extreme, states)]
        res = args[0].permute(2, 0, 1).contiguous()
        ref = mlp_filter_blocks_tl_reference(*args)
        got = mlp_filter_blocks(res, *args[1:8],
                                *(args[8:] if states else (None, None)))
        err = max(_max_err(got[0], ref[0].permute(2, 0, 1)),
                  _max_err(got[1], ref[1]), _max_err(got[2], ref[2]))
        C = frame_channels(B)
        frames = mlp_filter_frames(*(a.reshape((B // C, C) + a.shape[1:])
                                     for a in [res] + args[1:8]))
        zero = mlp_filter_blocks_tl_reference(*args[:8], None, None)[0]
        err = max(err, _max_err(frames, zero.reshape(NB * S, B // C, C)
                                .transpose(0, 1)))
        _require(err == 0, f"K1 layouts B={B} NB={NB} S={S}: max |kernel - "
                           f"plain| = {err}")
    print("[kernels] K1 lane-leading in, lane-leading and frame-major out, "
          "at the edge shapes (B x NB x S, C): " + "; ".join(
              f"{e[0]}x{e[1]}x{e[2]}, {frame_channels(e[0])}"
              for e in FILTER_EDGES) + ": bit-exact")
    b = example_batch(device=dev, **STEP)
    F, C, NB, S = b.residuals.shape
    lanes = [getattr(b, k) for k in ("residuals", "rc_fir", "rc_iir",
                                     "shift", "quant", "iir_reset",
                                     "iir_init", "block_len")]
    flat = [x.reshape((F * C,) + tuple(x.shape[2:])) for x in lanes]
    tl = (flat[0].permute(1, 2, 0).contiguous(), *flat[1:],
          flat[0].new_zeros((F * C, 8)), flat[0].new_zeros((F * C, 8)))
    calls = {"time_leading": lambda: mlp_filter_blocks_tl(*tl),
             "lane_leading": lambda: mlp_filter_blocks(*flat),
             "frame_major": lambda: mlp_filter_frames(*lanes)}
    want = mlp_filter_blocks_tl(*tl)[0]
    _require(torch.equal(mlp_filter_blocks(*flat)[0],
                         want.permute(2, 0, 1))
             and torch.equal(mlp_filter_frames(*lanes),
                             want.reshape(NB * S, F, C).transpose(0, 1)),
             "K1's layouts differ from each other at the step batch")
    times = {}
    for name in ("time_leading", "lane_leading", "frame_major",
                 "frame_major", "lane_leading", "time_leading"):
        times.setdefault(name, []).append(_times(calls[name], 50))
    # the bytes the lane-leading entries must move: residuals in, output
    # out, the parameters
    nbytes = _nbytes(*tl[:8]) + want.numel() * 4
    print(f"[kernels] K1 at the step batch [B, NB, S] = {F * C, NB, S} on "
          "the same inputs, card ms (in turns ms / ms; per call back to "
          "back): " + "; ".join(
              f"{k} {v[0][0]:.4f} / {v[1][0]:.4f} ({v[0][1]:.4f})"
              for k, v in times.items())
          + f"; bound {nbytes / HBM_BPS * 1e3:.4f} ms ({nbytes / 1e6:.2f} "
          "MB); all three equal")
    return {k: min(t[0] for t in v) for k, v in times.items()}


def _pcm_track_chunks(layout, track: int):
    """The chunk batch of a PCM track, from the port's reader's own packet
    walk: (uint8 [n, csize], bits, channels)."""
    import dvda_tpu_torch

    reader = (dvda_tpu_torch.open_disc(layout.path).open_titleset(1)
              .open_title(1).open_track(track).open_reader())
    chunks = reader._pcm_chunks()
    _require(chunks is not None, f"track {track}: no PCM chunks")
    return chunks.numpy(), reader.bits_per_sample, reader.channel_count


def phase_kernels(stream, plain, enc_path):
    """Each kernel against its plain version on the card."""
    import numpy as np
    import torch

    from dvda_tpu_torch.ops.mlp_filter import (mlp_filter_blocks_tl,
                                               mlp_filter_blocks_tl_reference)
    from dvda_tpu_torch.ops.rematrix import (output_stage,
                                             output_stage_reference)
    from dvda_tpu_torch.testutil import (FILTER_EDGES, OUTPUT_STAGE_EDGES,
                                         filter_inputs, output_stage_inputs)

    dev = torch.device("cuda", 0)
    results = {}

    # K1 at the headline chunk (256 chains x 6 channels, 16 blocks x 40)
    # and at the extreme-value pattern, then at the edge shapes of its
    # 32-lane blocks and 32-row tiles
    k1_err = 0
    for label, (B, NB, S), extreme, seed in (
            ("headline", (1536, 16, 40), False, 0),
            ("extreme", (128, 2, 8), True, 9)):
        args = [torch.from_numpy(np.asarray(x)).to(dev) for x in
                filter_inputs(seed, B, NB, S, extreme, states=True)]
        got = mlp_filter_blocks_tl(*args)
        ref = mlp_filter_blocks_tl_reference(*args)
        torch.cuda.synchronize()
        err = max(_max_err(g, r) for g, r in zip(got, ref))
        _require(err == 0, f"K1 {label}: max |kernel - plain| = {err}")
        k1_err = max(k1_err, err)
        print(f"[kernels] K1 mlp_filter {label} B={B} NB={NB} S={S}: "
              f"bit-exact")
        if label == "headline":
            ms, ev = _times(lambda: mlp_filter_blocks_tl(*args), 50)
            plain_ms = events_ms(
                lambda: mlp_filter_blocks_tl_reference(*args), 2)
            # per live sample: 8 FIR + 8 IIR int64 multiply-adds, the
            # shift, the quant mask and the residual add
            k1_cost = (_nbytes(*args, *got), 36 * int(args[7].sum()))
    for B, NB, S, extreme, states in FILTER_EDGES:
        args = [torch.from_numpy(np.asarray(x)).to(dev) for x in
                filter_inputs(B + S, B, NB, S, extreme, states)]
        err = max(_max_err(g, r) for g, r in zip(
            mlp_filter_blocks_tl(*args),
            mlp_filter_blocks_tl_reference(*args)))
        _require(err == 0, f"K1 B={B} NB={NB} S={S}: max |kernel - plain| "
                           f"= {err}")
    print("[kernels] K1 edge shapes (B x NB x S): " + "; ".join(
        f"{e[0]}x{e[1]}x{e[2]}{' extreme' if e[3] else ''}"
        for e in FILTER_EDGES) + ": bit-exact")
    print(f"[kernels] K1 headline: kernel {ms:.4f} ms on the card "
          f"({ev:.4f} ms per call back to back; {ms * 1e6 / (16 * 40):.1f} "
          f"ns per dependent step of 640), plain {plain_ms:.2f} ms per call")
    results["mlp_filter"] = _record(k1_err, ms, plain_ms, *k1_cost)
    results["mlp_filter"]["layouts"] = _kernel_k1_layouts(dev)

    # K234 at the headline chunk: 256 chains x 8 frames x L0=80, 6 channels,
    # 3 active matrix slots, 24-bit pack
    Bc, fpc, L0, C = 256, 8, 80, 6
    args = [torch.from_numpy(v).to(dev) for v in
            output_stage_inputs(1, Bc, fpc, L0, C, C, n_active=3).values()]
    k234_err = 0
    for nbytes in (3, 0):
        kw = dict(chains=Bc, n_mats=3, nbytes=nbytes)
        got = output_stage(*args, **kw)
        ref = output_stage_reference(*args, **kw)
        torch.cuda.synchronize()
        err = _max_err(got, ref)
        _require(err == 0, f"K234 nbytes={nbytes}: max |kernel - plain| = "
                           f"{err}")
        k234_err = max(k234_err, err)
    print(f"[kernels] K234 output_stage {Bc} chains x {fpc} frames x "
          f"L0={L0}, {C} ch, 3 matrices, 24- and 32-bit out: bit-exact")
    # the tiles' and strips' edges: ragged chain counts, L0 of 40-200
    for (eBc, efpc, eL0, C_tot, C_out, n_mats, nbytes,
         extreme) in OUTPUT_STAGE_EDGES:
        eargs = [torch.from_numpy(v).to(dev) for v in output_stage_inputs(
            eL0 + n_mats, eBc, efpc, eL0, C_tot, C_out,
            extreme=extreme).values()]
        kw = dict(chains=eBc, n_mats=n_mats, nbytes=nbytes)
        err = _max_err(output_stage(*eargs, **kw),
                       output_stage_reference(*eargs, **kw))
        _require(err == 0, f"K234 {eBc} chains, L0={eL0}: max |kernel - "
                           f"plain| = {err}")
    shapes = "; ".join(f"{s[0]}x{s[1]}x{s[2]}, {s[3]}->{s[4]} ch, {s[5]} "
                       f"slots, nbytes {s[6]}" for s in OUTPUT_STAGE_EDGES)
    print(f"[kernels] K234 edge shapes (chains x frames x L0): {shapes}: "
          "bit-exact")
    kw = dict(chains=Bc, n_mats=3, nbytes=3)
    ms, ev = _times(lambda: output_stage(*args, **kw), 50)
    plain_ms = events_ms(lambda: output_stage_reference(*args, **kw), 3)
    # per sample: 3 matrices x (10 multiply-adds, shift, mask, add), the
    # LFSR step, and per output channel its pick, shift and 3-byte store
    ops = Bc * fpc * L0 * (3 * 24 + 8 + C * 4)
    results["output_stage"] = _record(
        k234_err, ms, plain_ms, _nbytes(*args, output_stage(*args, **kw)),
        ops)
    print(f"[kernels] K234 headline: kernel {ms:.4f} ms on the card "
          f"({ev:.4f} ms per call back to back), bound "
          f"{results['output_stage']['bound_ms']:.4f} ms, plain "
          f"{plain_ms:.2f} ms per call")
    results["output_stage_narrow"] = _kernel_k234n(args, Bc, fpc, L0, C,
                                                   dev)

    # K5 at the headline chunk: both substreams (2 and 4 channels,
    # 256 chains x 16 blocks = 4,096 lanes of 40 samples each), the last
    # with the burst slot map; then the 39-bit symbols at every alignment
    from dvda_tpu_torch.ops.huffman_decode import (decode_residuals_device,
                                                   decode_residuals_reference)
    from dvda_tpu_torch.testutil import (HUFFMAN_EDGES, huffman_edge_inputs,
                                         huffman_worst_case)

    calls, lanes = _huffman_headline(stream, dev)
    k5_err = 0
    for i, (args, kw) in enumerate(calls):
        got = decode_residuals_device(*args, **kw)
        ref = decode_residuals_reference(*args, **kw)
        torch.cuda.synchronize()
        err = max(_max_err(g, r) for g, r in zip(got, ref))
        _require(err == 0, f"K5 substream {i}: max |kernel - plain| = {err}")
        k5_err = max(k5_err, err)
        _require(bool(got[0].any()), f"K5 substream {i}: all-zero residuals")
        print(f"[kernels] K5 huffman_decode substream {i}: L={args[2].shape[0]}"
              f" C={args[2].shape[1]} S0={args[7]} J={args[8]} "
              f"k={args[9]}{' + slot map' if 'bypk' in kw else ''}: "
              "bit-exact")
    for align in range(32):
        case = huffman_worst_case(align)
        args = [torch.from_numpy(np.asarray(case[n])).to(dev) for n in (
            "bitpos", "codebook", "lsb_bits", "offset", "quant", "nbyp")]
        words = torch.from_numpy(case["words"].view(np.int32)).to(dev)
        tail = (case["S0"], case["J"], case["k"])
        for NB0 in (0, 3):  # three lanes, or one chain of three blocks
            got = decode_residuals_device(words, *args, *tail, NB0=NB0)
            ref = decode_residuals_reference(words, *args, *tail, NB0=NB0)
            torch.cuda.synchronize()
            err = max(_max_err(g, r) for g, r in zip(got, ref))
            _require(err == 0, f"K5 39-bit case align {align} NB0={NB0}: "
                               f"error {err}")
            k5_err = max(k5_err, err)
    print("[kernels] K5 39-bit symbols (6 burst + 9 code + 24 LSB bits), "
          "all 32 start alignments, NB0 0 and 3: bit-exact")
    for edge in HUFFMAN_EDGES:
        case = huffman_edge_inputs(edge)
        args = [torch.from_numpy(case["words"].view(np.int32)).to(dev)] + [
            torch.from_numpy(np.asarray(case[n])).to(dev) for n in (
                "bitpos", "codebook", "lsb_bits", "offset", "quant",
                "nbyp")] + [case["S0"], case["J"], case["k"]]
        kw = dict(NB0=case["NB0"], word_base=torch.tensor(
            [case["word_base"]], dtype=torch.int32, device=dev))
        if case["slots"]:
            kw.update(bypk=torch.from_numpy(case["bypk"]).to(dev),
                      bypv=torch.from_numpy(case["bypv"]).to(dev))
        err = max(_max_err(g, r) for g, r in zip(
            decode_residuals_device(*args, **kw),
            decode_residuals_reference(*args, **kw)))
        _require(err == 0, f"K5 edge case {edge[0]}: max |kernel - plain| = "
                           f"{err}")
        k5_err = max(k5_err, err)
    print(f"[kernels] K5 edge cases ({', '.join(e[0] for e in HUFFMAN_EDGES)}"
          "): bit-exact")

    # the main path's form: each substream into its lanes of the fused
    # filter input (out, lane0)
    fused = torch.full_like(lanes.residuals[0], -7)

    def k5_chunk():  # the chunk's two launches
        for (args, kw), (_, lane0) in zip(calls, lanes.places):
            decode_residuals_device(*args, **kw, out=fused, lane0=lane0)

    k5_chunk()
    want = torch.cat([decode_residuals_reference(*args, **kw)[0]
                      for args, kw in calls], 2)
    torch.cuda.synchronize()
    err = _max_err(fused, want)
    _require(err == 0, f"K5 into the fused filter input: max |kernel - "
                       f"plain| = {err}")
    print(f"[kernels] K5 both substreams into the fused filter input "
          f"{tuple(fused.shape)} at lanes {[p[1] for p in lanes.places]}: "
          "bit-exact")

    def k5_plain():
        for args, kw in calls:
            decode_residuals_reference(*args, **kw)

    ms, ev = _times(k5_chunk, 50)
    plain_ms = events_ms(k5_plain, 3)
    # the serial symbols of the chunk: k samples x C slots a sub-lane, the
    # two launches one after the other
    serial = sum(args[9] * args[2].shape[1] for args, _ in calls)
    stream_bytes = len(stream) * 8 * CHUNK // HEADLINE["n_frames"]
    print(f"[kernels] K5 headline chunk (2 launches): kernel {ms:.4f} ms on "
          f"the card ({ev:.4f} ms per chunk back to back; "
          f"{ms * 1e6 / serial:.1f} ns per dependent symbol of {serial}), "
          f"plain {plain_ms:.2f} ms per chunk; {stream_bytes / 1e6:.3f} MB "
          f"of stream a chunk ({stream_bytes / CHUNK:.0f} B a chain)")
    # of the stream words the chunk reads its own frames' share (8 of the
    # disc's frames per chain); per decoded residual about 24 integer
    # operations (peek, table lookup, LSB extract, sign, offset, quant)
    nbytes = stream_bytes + sum(
        _nbytes(*args[1:], *kw.values(), *decode_residuals_device(*args, **kw))
        for args, kw in calls)
    n_res = sum(decode_residuals_device(*args, **kw)[0].numel()
                for args, kw in calls)
    results["huffman_decode"] = _record(k5_err, ms, plain_ms, nbytes,
                                        24 * n_res)
    results["chunk_lanes"] = _kernel_k10(stream, dev)
    results["mlp_filter_arena"] = _kernel_k1a(stream, dev)
    results["pcm_unpack"] = _kernel_k8(plain, dev)
    results["c2_decrypt"] = _kernel_k7(plain, enc_path, dev)
    results["frame_remix"] = _kernel_k9(dev)
    return results


def _kernel_k234n(args, Bc: int, fpc: int, L0: int, C: int, dev):
    """K234n against its plain version, bit-exact with its flag rows: at
    the headline chunk (``args``, K234's inputs) at both tiers, at K234's
    edge shapes, and with samples at the tiers' ends so that the flag
    takes each of 0-3; its card time at the headline at tier 16 (the
    headline's tier on the main path) and at tier 12."""
    import numpy as np
    import torch

    from dvda_tpu_torch.ops.rematrix import (output_stage,
                                             output_stage_reference)
    from dvda_tpu_torch.testutil import (NARROW_EDGES, NARROW_RANGES,
                                         narrow_stage_inputs,
                                         output_stage_inputs)

    def check(a, chains, n_mats, tier, label):
        kw = dict(chains=chains, n_mats=n_mats, nbytes=3, tier=tier)
        got = output_stage(*a, **kw)
        err = _max_err(got, output_stage_reference(*a, **kw))
        _require(err == 0, f"K234n {label} tier {tier}: max |kernel - "
                           f"plain| = {err}")
        return int(got[-1, -1].item())

    for tier in (12, 16):
        check(args, Bc, 3, tier, "headline")
    for (eBc, efpc, eL0, C_tot, C_out, n_mats, _, extreme), tier in \
            NARROW_EDGES:
        eargs = [torch.from_numpy(v).to(dev) for v in output_stage_inputs(
            eL0 + n_mats, eBc, efpc, eL0, C_tot, C_out,
            extreme=extreme).values()]
        check(eargs, eBc, n_mats, tier, f"{eBc}x{efpc}x{eL0}")
    flags = set()
    for lo, hi, want12, want16 in NARROW_RANGES:
        fargs = [torch.from_numpy(v).to(dev) for v in narrow_stage_inputs(
            7, Bc, fpc, L0, C, C, lo, hi).values()]
        for tier, want in ((12, want12), (16, want16)):
            flag = check(fargs, Bc, 6, tier, f"[{lo}, {hi}]")
            _require(flag == want, f"K234n [{lo}, {hi}] tier {tier}: flag "
                                   f"{flag}, expected {want}")
            flags.add(flag)
    _require(flags == {0, 1, 2, 3}, f"K234n flags seen: {sorted(flags)}")
    # two launches in a row on one stream: the second flag is its own
    loud, quiet = ([torch.from_numpy(v).to(dev) for v in narrow_stage_inputs(
        seed, Bc, fpc, L0, C, C, lo, hi).values()]
        for seed, lo, hi in ((5, -32769, 32768), (6, -2048, 2047)))
    for tier, want in ((12, 3), (16, 1)):
        first = check(loud, Bc, 6, tier, "loud")
        second = check(quiet, Bc, 6, tier, "quiet after loud")
        _require((first, second) == (0, want),
                 f"K234n tier {tier}, two launches in a row: flags "
                 f"{first}, {second}, expected 0, {want}")
    print(f"[kernels] K234n output_stage narrow, headline chunk at tiers 12 "
          f"and 16, {len(NARROW_EDGES)} edge cases, samples at the tiers' "
          f"ends (flags {sorted(flags)}), a loud then a quiet chunk on one "
          "stream (flags 0 then 3 / 1): bit-exact, flag rows included")
    times = {}
    for tier in (16, 12):
        kw = dict(chains=Bc, n_mats=3, nbytes=3, tier=tier)
        ms, ev = _times(lambda: output_stage(*args, **kw), 50)
        plain_ms = events_ms(lambda: output_stage_reference(*args, **kw), 3)
        out = output_stage(*args, **kw)
        times[tier] = (ms, plain_ms, out.numel())
        print(f"[kernels] K234n headline tier {tier}: kernel {ms:.4f} ms on "
              f"the card ({ev:.4f} ms per call back to back), plain "
              f"{plain_ms:.2f} ms per call; {out.numel()} bytes out")
    ms, plain_ms, out_bytes = times[16]
    # K234's operations, and per output value its two compares
    ops = Bc * fpc * L0 * (3 * 24 + 8 + C * 6)
    rec = _record(0, ms, plain_ms, _nbytes(*args) + out_bytes, ops)
    print(f"[kernels] K234n bound at tier 16: {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})")
    return rec


def _k9_plain(args, n_mats):
    from dvda_tpu_torch.ops.rematrix import (apply_output_stage_reference,
                                             rematrix_frames_reference)

    return apply_output_stage_reference(
        rematrix_frames_reference(*args[:8], n_mats), args[8], args[9])


def _k9_check(args, n_mats: int, label: str, reps: int = 50):
    """K9 against its plain version on ``args`` (frame_remix's positional
    arguments, on the card but ``wave_perm``): (max error, kernel ms, plain
    ms, bytes, operations)."""
    import torch

    from dvda_tpu_torch.ops.rematrix import frame_remix

    got = frame_remix(*args, n_mats)
    ref = _k9_plain(args, n_mats)
    torch.cuda.synchronize()
    err = _max_err(got, ref)
    _require(err == 0, f"K9 {label}: max |kernel - plain| = {err}")
    _require(bool(got.any()), f"K9 {label}: all-zero output")
    ms, ev = _times(lambda: frame_remix(*args, n_mats), reps)
    plain_ms = events_ms(lambda: _k9_plain(args, n_mats), 3)
    F, L, C = args[0].shape
    C_out = got.shape[2]
    # bytes: channels, noise, the active slots' bypass rows (no other row
    # reaches the output), the frame tables and the output, each once;
    # operations per sample: per active slot the int64 dot over C + 2 terms
    # (multiply and add), shift, mask, add and select, then per output
    # channel its pick and shift
    active = int(args[5][:, :n_mats].sum())  # (frame, slot) pairs
    nbytes = (_nbytes(args[0], args[1], *args[2:7], args[8], got)
              + active * L * 4)
    ops = L * (active * (2 * (C + 2) + 4) + F * 3 * C_out)
    rec = _record(err, ms, plain_ms, nbytes, ops)
    print(f"[kernels] K9 frame_remix {label} [F, L, C] = {F, L, C}, "
          f"{n_mats} slots -> C_out={C_out}: bit-exact; kernel {ms:.4f} ms "
          f"on the card ({ev:.4f} ms per call back to back), bound "
          f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}, "
          f"{nbytes / 1e6:.2f} MB), plain {plain_ms:.2f} ms per call")
    return err, ms, plain_ms, nbytes, ops


def _kernel_k9(dev):
    """K9 at the fused step's production batch (the frame-major tensors of
    ``example_batch``; channels from K1 on that batch), at the extreme
    value and shift-edge pattern and at ``testutil.FRAME_REMIX_EDGES``."""
    import torch

    from dvda_tpu_torch.ops.rematrix import frame_remix
    from dvda_tpu_torch.parallel.step import _filtered, example_batch
    from dvda_tpu_torch.testutil import (FRAME_REMIX_EDGES,
                                         frame_remix_edge_args,
                                         frame_remix_inputs)

    b = example_batch(device=dev, **STEP)
    channels = _filtered({k: getattr(b, k) for k in (
        "residuals", "rc_fir", "rc_iir", "shift", "quant", "iir_reset",
        "iir_init", "block_len")})
    args = [channels, b.noise, b.mat_coeff, b.mat_noise, b.mat_out,
            b.mat_active, b.mat_quant, b.bypassed, b.output_shift,
            b.wave_perm]
    rec = _k9_check(args, 6, "step batch")
    edge = [torch.from_numpy(a).to(dev) for a in frame_remix_inputs(
        7, 64, 80, 8, 6, extreme=True, edges=True)]
    edge[9] = edge[9].cpu()
    _k9_check(edge, 6, "extreme + shift edges", reps=5)
    for case in FRAME_REMIX_EDGES:
        args, n_mats = frame_remix_edge_args(case, dev)
        got = frame_remix(*args, n_mats)
        err = _max_err(got, _k9_plain(args, n_mats))
        _require(err == 0, f"K9 edge {case[0]}: max |kernel - plain| = {err}")
    print(f"[kernels] K9 frame_remix at FRAME_REMIX_EDGES: "
          f"{len(FRAME_REMIX_EDGES)} cases bit-exact")
    return _record(*rec)


def _kernel_k8(plain, dev):
    """K8: every (bps, channels) config at 64 random chunks in both output
    forms, then at ``testutil.PCM_EDGES``, then the whole 30 s 5.1/96k/24
    track."""
    import numpy as np
    import torch

    from dvda_tpu_torch.codecs.pcm import chunk_size, pcm_gather_indices
    from dvda_tpu_torch.ops.pcm_unpack import (decode_chunks_device,
                                               decode_chunks_reference)
    from dvda_tpu_torch.testutil import PCM_EDGES

    rng = np.random.default_rng(3)
    err = 0
    for bits in (16, 20, 24):
        for ch in range(1, 7):
            chunks = torch.from_numpy(rng.integers(
                0, 256, (64, chunk_size(bits, ch)), dtype=np.uint8)).to(dev)
            for nbytes in (0, 2 if bits == 16 else 3):
                got = decode_chunks_device(chunks, bits, ch, nbytes)
                ref = decode_chunks_reference(chunks, bits, ch, nbytes)
                torch.cuda.synchronize()
                e = _max_err(got, ref)
                _require(e == 0, f"K8 {bits}-bit {ch} ch nbytes={nbytes}: "
                                 f"max |kernel - plain| = {e}")
                err = max(err, e)
    print("[kernels] K8 pcm_unpack: 18 configs (16/20/24-bit x 1-6 ch) x 64 "
          "chunks, int32 and packed bytes: bit-exact")
    # the tile edges: every config in every output form at each count
    for n in PCM_EDGES:
        for bits in (16, 20, 24):
            for ch in range(1, 7):
                chunks = torch.from_numpy(rng.integers(
                    0, 256, (n, chunk_size(bits, ch)), dtype=np.uint8)).to(dev)
                for nbytes in (0, 2, 3):
                    e = _max_err(decode_chunks_device(chunks, bits, ch, nbytes),
                                 decode_chunks_reference(chunks, bits, ch,
                                                         nbytes))
                    _require(e == 0, f"K8 n={n} {bits}-bit {ch} ch "
                                     f"nbytes={nbytes}: error {e}")
    buf = torch.zeros(64 * 36 + 4, dtype=torch.uint8, device=dev)
    try:
        decode_chunks_device(buf[4:].view(64, 36), 24, 6, 3)
        _require(False, "K8 took a batch that is not 16-byte aligned")
    except ValueError:
        pass
    print(f"[kernels] K8 at n = {', '.join(map(str, PCM_EDGES))} chunks x 18 "
          "configs x nbytes 0/2/3: bit-exact; a misaligned batch raises")
    host_chunks, bits, ch = _pcm_track_chunks(plain, 2)
    chunks = torch.from_numpy(host_chunks.copy()).to(dev)
    n = chunks.shape[0]
    for nbytes in (0, 3):
        got = decode_chunks_device(chunks, bits, ch, nbytes)
        ref = decode_chunks_reference(chunks, bits, ch, nbytes)
        torch.cuda.synchronize()
        e = _max_err(got, ref)
        _require(e == 0, f"K8 full track nbytes={nbytes}: error {e}")
        err = max(err, e)
    _require(bool(got.any()), "K8 full track: all-zero output")
    times = {}
    for nbytes in (3, 0):
        times[nbytes] = (
            _times(lambda: decode_chunks_device(chunks, bits, ch, nbytes),
                   50)[0],
            events_ms(lambda: decode_chunks_reference(chunks, bits, ch,
                                                      nbytes), 2))
    # the packed form is a byte permutation: one index_select of the
    # chunk bytes by the composed gather table (the host pcm_repack's)
    nb = bits // 8
    table = pcm_gather_indices(bits, ch)[:, :nb].reshape(-1)
    _require(bool((table >= 0).all()), "K8: the gather table has holes")
    table = torch.from_numpy(table.astype(np.int64)).to(dev)
    packed = decode_chunks_device(chunks, bits, ch, nb)
    _require(torch.equal(chunks.index_select(1, table).reshape(packed.shape),
                         packed), "K8: index_select differs from the kernel")
    library_ms = _times(lambda: chunks.index_select(1, table), 50)[0]
    print(f"[kernels] K8 full {SECONDS} s {ch}-ch {bits}-bit track, {n} chunks "
          f"({host_chunks.nbytes / 1e6:.2f} MB): bit-exact; kernel "
          f"{times[3][0]:.4f} ms packed / {times[0][0]:.4f} ms int32, "
          f"index_select {library_ms:.4f} ms on the card; plain "
          f"{times[3][1]:.2f} / {times[0][1]:.2f} ms per call")
    return _record(err, times[3][0], times[3][1], _nbytes(chunks, packed),
                   packed.numel(), library_ms)


def _kernel_k7(plain, enc_path, dev):
    """K7 on the encrypted disc's first AOB batch (4,096 sectors), with
    ``preserve_cci`` both ways, then at ``testutil.C2_EDGES``, against its
    plain version and the port's host C2."""
    import numpy as np
    import torch

    from dvda_tpu_torch import host
    from dvda_tpu_torch.container.aob import AOBReader
    from dvda_tpu_torch.cppm.decrypt import CppmDecryptor
    from dvda_tpu_torch.ops.c2_decrypt import (decrypt_sectors_device,
                                               decrypt_sectors_reference)
    from dvda_tpu_torch.testutil import C2_EDGES, c2_edge_batch

    enc = AOBReader(enc_path, 1).read_sectors(0, 4096).copy()
    k_au = CppmDecryptor(MEDIA_KEY, ALBUM).k_au
    err = 0
    for preserve in (False, True):
        got = torch.from_numpy(enc.copy()).to(dev)  # K7 works in place
        decrypt_sectors_device(got, k_au, preserve)
        ref = decrypt_sectors_reference(torch.from_numpy(enc).to(dev), k_au,
                                        preserve)
        torch.cuda.synchronize()
        e = _max_err(got, ref)
        _require(e == 0, f"K7 preserve_cci={preserve}: max |kernel - plain|"
                         f" = {e}")
        err = max(err, e)
        want = enc.copy()
        _require(host.c2_decrypt_sectors(want, MEDIA_KEY, ALBUM, preserve)
                 == enc.shape[0], "host C2: not every sector was scrambled")
        _require(np.array_equal(got.cpu().numpy(), want),
                 f"K7 preserve_cci={preserve}: differs from the host C2")
    print(f"[kernels] K7 c2_decrypt: the CPPM disc's first {enc.shape[0]} "
          "sectors, preserve_cci both ways: bit-exact against the plain "
          "version and the port's host C2")
    # the block edges: batches of 1-97 sectors from the plaintext disc,
    # each 32-sector block mixing scrambled, clear and non-pack sectors
    disc = AOBReader(plain.path, 1).read_sectors(0, 300).copy()
    for n, seed in C2_EDGES:
        _, batch = c2_edge_batch(disc, n, MEDIA_KEY, ALBUM, seed)
        for preserve in (False, True):
            for key in (k_au, k_au ^ 1 << 40):
                got = torch.from_numpy(batch.copy()).to(dev)
                decrypt_sectors_device(got, key, preserve)
                e = _max_err(got, decrypt_sectors_reference(
                    torch.from_numpy(batch).to(dev), key, preserve))
                _require(e == 0, f"K7 {n} sectors preserve_cci={preserve} "
                                 f"key {key:#x}: error {e}")
                if key == k_au:
                    want = batch.copy()
                    host.c2_decrypt_sectors(want, MEDIA_KEY, ALBUM, preserve)
                    _require(np.array_equal(got.cpu().numpy(), want),
                             f"K7 {n} sectors: differs from the host C2")
    print(f"[kernels] K7 at {', '.join(str(n) for n, _ in C2_EDGES)} "
          "sectors, preserve_cci both ways, the right and a wrong key: "
          "bit-exact (and == the host C2 with the right key)")
    # each timed launch decrypts its own copy of the batch (the kernel
    # works in place: a decrypted sector is no longer scrambled)
    reps = 50
    # enough copies for the warm-up, a repeated queued run and the events
    copies = torch.from_numpy(enc).to(dev).unsqueeze(0).repeat(6 * reps + 3,
                                                               1, 1)
    it = iter(range(6 * reps + 3))
    ms, ev = _times(lambda: decrypt_sectors_device(copies[next(it)], k_au),
                    reps)
    # the plain version leaves its input as it is: 2 calls on the batch
    batch = torch.from_numpy(enc).to(dev)
    plain_ms = events_ms(
        lambda: decrypt_sectors_reference(batch, k_au, False), 2)
    # in place: each sector read and written once.  Per scrambled sector
    # (the host C2 found every one of the batch scrambled) 5 content-key
    # c2_g calls of ~300 operations and 240 8-byte blocks x 10 rounds of
    # ~20 operations (cppm.c:481-566)
    rec = _record(err, ms, plain_ms, 2 * enc.nbytes,
                  enc.shape[0] * (5 * 300 + 240 * 10 * 20))
    # the chain: a sector's 240 words run one after another (a 2-round
    # schedule and 5 rounds each on it); tools/torch_timing_check.py
    # chains measures a round's and a word's dependent cycles
    print(f"[kernels] K7 one {enc.shape[0]}-sector batch: kernel {ms:.4f} "
          f"ms on the card ({ev:.4f} ms per launch back to back; "
          f"{ms * 1e6 / 240:.1f} ns per word of the 240-word chain), byte "
          f"bound {rec['bound_ms']:.4f} ms, plain {plain_ms:.2f} ms per "
          "call (2 calls)")
    return rec


def phase_main(layout, cfg, smi: str):
    """The 30-second disc through the port's reader API on the card, in
    standard and in device-Huffman mode, each with the narrow readback on
    (the default: K234n) and off (K234)."""
    import numpy as np
    import torch

    import dvda_tpu_torch
    from dvda_tpu_torch.codecs.mlp.native_engine import (decode_host_complete,
                                                         decode_native,
                                                         global_timer)
    from dvda_tpu_torch.codecs.mlp.track import assemble_track_stream
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.ops.chunk_filter import chunk_filter
    from dvda_tpu_torch.ops.chunk_lanes import chunk_lanes
    from dvda_tpu_torch.ops.huffman_decode import decode_residuals_device
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl
    from dvda_tpu_torch.ops.rematrix import output_stage

    counters = {"mlp_filter_arena": chunk_filter,
                "chunk_lanes": chunk_lanes,
                "mlp_filter": mlp_filter_blocks_tl,
                "output_stage": output_stage,
                "huffman_decode": decode_residuals_device}
    # narrow on and off alternate in every round below
    modes = {f"{m}{'' if narrow else '_wide'}": DecodeConfig(
        device="cuda", device_huffman=m == "device_huffman",
        narrow_d2h=narrow)
        for m in ("standard", "device_huffman") for narrow in (True, False)}

    def port_decode(conf):
        reader = (dvda_tpu_torch.open_disc(layout.path, config=conf)
                  .open_titleset(1).open_title(1).open_track(1)
                  .open_reader())
        t = time.perf_counter()
        out = reader.read_all_packed()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, reader

    got, reader_s, launches, tiers = {}, {}, {}, {}
    for mode, conf in modes.items():
        for fn in counters.values():
            fn.launches = 0
        output_stage.narrow_launches = 0
        got[mode], first, reader = port_decode(conf)
        launches[mode] = {k: fn.launches for k, fn in counters.items()}
        launches[mode]["output_stage_narrow"] = output_stage.narrow_launches
        info = reader.decode_info
        tiers[mode] = (info["tier"], info["redone"], info["drained"])
        _, second, _ = port_decode(conf)
        reader_s[mode] = (first, second)
    for mode, n in launches.items():
        huffman = mode.startswith("device")
        k1a = n["mlp_filter_arena"]
        k234 = ((n["output_stage_narrow"] >= 18 and n["output_stage"] == 0)
                if modes[mode].narrow_d2h else
                (n["output_stage"] >= 18 and n["output_stage_narrow"] == 0))
        # K1a once a chunk (the two substreams fuse), never K1; in device
        # Huffman K10 (K5's inputs) once and K5 twice a chunk before it
        _require(k1a >= 18 and k234 and n["mlp_filter"] == 0
                 and n["chunk_lanes"] == (k1a if huffman else 0)
                 and n["huffman_decode"] == (2 * k1a if huffman else 0),
                 f"{mode} decode did not run its kernels: {n}")
        _require(tiers[mode][0] == (16 if modes[mode].narrow_d2h else 0),
                 f"{mode}: the headline settled at tier {tiers[mode][0]}")

    # like for like: every executor from the same assembled stream,
    # interleaved (narrow on, off, in each mode), best of 5 (host clock
    # around work that ends synchronised); the stage timers of each
    # mode's best run
    stream, bnd, probe_end = assemble_track_stream(reader.aob,
                                                   reader.track.span)
    threads = modes["standard"].resolved_parse_threads()
    times = {m: [] for m in (*modes, "host")}
    stages, outs, infos = {}, {}, {}
    for _ in range(5):
        for who in times:
            global_timer.reset()
            info = {}
            t = time.perf_counter()
            if who == "host":
                outs[who] = decode_host_complete(stream, bnd, probe_end,
                                                 reader.parameters, True,
                                                 threads)
            else:
                outs[who] = decode_native(stream, bnd, probe_end,
                                          reader.parameters, True,
                                          modes[who], info=info)
                torch.cuda.synchronize()
            dt = time.perf_counter() - t
            if not times[who] or dt < min(times[who]):
                stages[who] = dict(global_timer.totals)
            times[who].append(dt)
            infos[who] = info
    want = SECONDS * cfg.sample_rate * cfg.channels * 3
    ref = outs["host"].reshape(-1)
    _require(ref.nbytes == want, f"host-complete gave {ref.nbytes} bytes, "
                                 f"expected {want}")
    for mode in modes:
        _require(isinstance(got[mode], bytes) and len(got[mode]) == want,
                 f"{mode}: port gave {len(got[mode])} bytes, expected {want}")
        _require(np.array_equal(np.frombuffer(got[mode], np.uint8), ref)
                 and np.array_equal(outs[mode].reshape(-1), ref),
                 f"{mode}: port bytes differ from the host-complete "
                 "reconstruction")
    print(f"[main] read_all_packed == decode_native == host-complete in "
          f"both modes, narrow readback on and off: {want} bytes identical")
    for mode in modes:
        tier, redone, drained = tiers[mode]
        print(f"[main] {mode} launches {launches[mode]}; settled tier "
              f"{tier}, {redone} chunks run again, {drained} bytes drained"
              f" (decode_native: tier {infos[mode]['tier']}, "
              f"{infos[mode]['redone']} again, {infos[mode]['drained']} "
              "bytes)")
    print(f"[main] {smi}; from the assembled stream, best of 5 interleaved, "
          f"{threads} parse threads:")
    for who in times:
        best = min(times[who])
        timers = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                          sorted(stages[who].items()))
        extra = (f"; reader read_all_packed {reader_s[who][0]:.4f} s first,"
                 f" {reader_s[who][1]:.4f} s second" if who in reader_s
                 else "")
        print(f"[main]   {who}: {best:.4f} s = {SECONDS / best:.1f}x "
              f"realtime (runs {', '.join(f'{x:.4f}' for x in times[who])})"
              f"{extra}; stages {timers}")
    for mode in modes:
        K1A_PATHS[mode] = launches[mode]["mlp_filter_arena"]
    K1A_PATHS["iter_packed"] = _iter_packed_check(layout, got["standard"],
                                                  counters, output_stage)
    return {"chunk_lanes": sum(n["chunk_lanes"] for n in launches.values()),
            "output_stage": launches["standard_wide"]["output_stage"],
            "output_stage_narrow":
                launches["standard"]["output_stage_narrow"],
            "huffman_decode": launches["device_huffman"]["huffman_decode"]}


def _iter_packed_check(layout, want: bytes, counters, output_stage) -> int:
    """``iter_packed`` on the headline disc, at the default segment (30 s:
    the whole track, one chunk) and at 5 s segments (six, cut at the
    manifest's resume points, each decoded on its own by K1a + K234n on
    the card: none handed to the spec decoder on the host), both equal to
    ``read_all_packed()``; returns the 5 s run's K1a launches."""
    import torch

    from dvda_tpu_torch.codecs.mlp.track import decode_segment
    from dvda_tpu_torch.config import DecodeConfig

    conf = DecodeConfig(device="cuda")
    rate = HEADLINE["sample_rate"]
    for segment, n_chunks in ((None, 1), (5 * rate, SECONDS // 5)):
        reader = _open_track(layout, conf)
        for fn in counters.values():
            fn.launches = 0
        output_stage.narrow_launches = 0
        decode_segment.spec_fallbacks = 0
        t = time.perf_counter()
        chunks = [bytes(c) for c in reader.iter_packed(segment)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        k1 = counters["mlp_filter_arena"].launches
        k234n = output_stage.narrow_launches
        _require(len(chunks) == n_chunks,
                 f"iter_packed({segment}): {len(chunks)} chunks, not "
                 f"{n_chunks}")
        _require(b"".join(chunks) == want,
                 f"iter_packed({segment}): {len(chunks)} chunks differ "
                 "from read_all_packed")
        _require(decode_segment.spec_fallbacks == 0,
                 f"iter_packed({segment}): {decode_segment.spec_fallbacks} "
                 "segments decoded on the spec decoder, not the card")
        _require(k1 >= len(chunks) and k234n >= len(chunks),
                 f"iter_packed({segment}) did not run K1a and K234n on "
                 f"each segment: {k1}, {k234n}")
        print(f"[main] iter_packed(segment_pcm_frames={segment}): "
              f"{len(chunks)} chunks == read_all_packed, {wall:.4f} s "
              f"(manifest parse + segment decodes), K1a {k1} launches, "
              f"K234n {k234n}")
    return k1


def _arena_check(stream) -> None:
    """The headline's first chunk and its last (partial) chunk built by
    ``mp_pack`` and by the numpy builder, pinned as the decode builds
    them, in standard and device-Huffman mode: byte-equal arenas, equal
    specs."""
    import torch

    from dvda_tpu_torch.codecs.mlp import native_engine as ne

    n_chains = HEADLINE["n_frames"] * L0 // (NB0 * S0)
    last = (n_chains - 1) // CHUNK * CHUNK
    for huffman in (False, True):
        inc = ne.host.parse_mlp_stream_begin(stream, skip_values=huffman)
        try:
            inc.step(0)
            v = inc.view()
            _require(v.status == 0 and v.substream_count == 2,
                     "the headline's parse failed")
            subs = [(v.sub[s], 0, S0, NB0, 0) for s in range(2)]
            mat_mm = ne._max_matrix_slots(v.mat_active)
            for c0, c1 in ((0, CHUNK), (last, n_chains)):
                (mine, spec), (theirs, want) = (ne._build_chunk_arenas(
                    v, subs, c0, c1, CHUNK, NB0 * S0, L0, 6, 24, 0, 0,
                    mat_mm, pin=True, huffman=huffman, narrow=16,
                    native=native) for native in (False, True))
                _require(spec == want and all(
                    a.is_pinned() and torch.equal(a, b)
                    for a, b in zip(mine, theirs)),
                    f"chunk [{c0}, {c1}) (device Huffman {huffman}): the "
                    "numpy arenas differ from mp_pack's")
        finally:
            inc.close()
    print(f"[modes] numpy arena builder == mp_pack on chains [0, {CHUNK}) "
          f"and [{last}, {n_chains}), standard and device Huffman: arenas "
          "byte-equal, specs equal")


def phase_modes(layout, smi: str):
    """The headline disc through the modules of slice 13 on the card, each
    equal to host-complete with its kernels' launches counted: the numpy
    arena builder (``native_pack=False``) in both modes, also equal to
    the ``mp_pack`` decode, with the ``mlp/arena-build`` stage of each
    (best of 3, alternating); the chunk round-robin over ``[cuda:0,
    cuda:0]`` and over every visible card; the drain without its side
    stream (``drain_thread=False``) with the narrow readback on (tier 16)
    and off."""
    import numpy as np
    import torch

    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.codecs.mlp.native_engine import global_timer
    from dvda_tpu_torch.codecs.mlp.track import assemble_track_stream
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.ops.chunk_filter import chunk_filter
    from dvda_tpu_torch.ops.chunk_lanes import chunk_lanes
    from dvda_tpu_torch.ops.huffman_decode import decode_residuals_device
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl
    from dvda_tpu_torch.ops.rematrix import output_stage

    reader = _open_track(layout, DecodeConfig(device="cuda"))
    stream, bnd, probe_end = assemble_track_stream(reader.aob,
                                                   reader.track.span)
    _arena_check(stream)
    threads = DecodeConfig().resolved_parse_threads()
    ref = ne.decode_host_complete(stream, bnd, probe_end, reader.parameters,
                                  True, threads).reshape(-1)
    n_chunks = -(-HEADLINE["n_frames"] * L0 // (NB0 * S0 * CHUNK))
    k1_total = 0

    def run(label, conf, devices=None):
        """One ``read_all_packed()`` through the reader on ``conf`` (with
        ``devices`` as the round-robin's list): == host-complete, K1a and
        K234n (K234 with narrow off; K10 and K5 in device Huffman) launched
        for each chunk, K1 never."""
        nonlocal k1_total
        real = ne._decode_devices
        if devices is not None:
            ne._decode_devices = lambda cfg: devices
        try:
            _zero_launches()
            t = time.perf_counter()
            r = _open_track(layout, conf)
            out = r.read_all_packed()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            ne._decode_devices = real
        k1 = chunk_filter.launches
        k10 = chunk_lanes.launches
        k5 = decode_residuals_device.launches
        k234, k234n = output_stage.launches, output_stage.narrow_launches
        info = r.decode_info
        _require(np.array_equal(np.frombuffer(out, np.uint8), ref),
                 f"{label}: bytes differ from host-complete")
        narrow = conf.resolved_narrow_d2h()
        _require(info["chunks"] == n_chunks and k1 >= n_chunks
                 and mlp_filter_blocks_tl.launches == 0
                 and k10 == (k1 if conf.device_huffman else 0)
                 and (k234n if narrow else k234) >= n_chunks
                 and (k234 if narrow else k234n) == 0
                 and (k5 >= 2 * n_chunks if conf.device_huffman
                      else k5 == 0),
                 f"{label}: did not run its kernels: K10 {k10}, K1a {k1}, "
                 f"K5 {k5}, "
                 f"K234 {k234}, K234n {k234n}, {info['chunks']} chunks")
        _require(info["tier"] == (16 if narrow else 0),
                 f"{label}: settled at tier {info['tier']}")
        k1_total += k1
        print(f"[modes] {label}: == host-complete, {wall:.4f} s; launches "
              f"K10 {k10}, K1a {k1}, K5 {k5}, K234 {k234}, K234n {k234n}; tier "
              f"{info['tier']}, {info['redone']} chunks run again, "
              f"{info['drained']} bytes drained")

    for huffman in (False, True):
        mode = "device_huffman" if huffman else "standard"
        run(f"{mode} native_pack off",
            DecodeConfig(device="cuda", device_huffman=huffman,
                         native_pack=False))
    # the two builders on the same assembled stream, alternating
    walls, build = {}, {}
    for _ in range(3):
        for huffman in (False, True):
            for native in (True, False):
                key = (f"{'device_huffman' if huffman else 'standard'} "
                       f"{'mp_pack' if native else 'numpy'}")
                conf = DecodeConfig(device="cuda", device_huffman=huffman,
                                    native_pack=native)
                global_timer.reset()
                t = time.perf_counter()
                out = ne.decode_native(stream, bnd, probe_end,
                                       reader.parameters, True, conf)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                _require(np.array_equal(out.reshape(-1), ref),
                         f"{key}: decode_native differs from host-complete")
                if key not in walls or dt < min(walls[key]):
                    build[key] = global_timer.totals.get("mlp/arena-build",
                                                         0.0)
                walls.setdefault(key, []).append(dt)
    print(f"[modes] {smi}; decode_native from the assembled stream, "
          "best of 3 alternating, mp_pack and the numpy builder:")
    for key, ts in walls.items():
        print(f"[modes]   {key}: {min(ts):.4f} s (runs "
              f"{', '.join(f'{x:.4f}' for x in ts)}); mlp/arena-build "
              f"{build[key] * 1e3:.1f} ms for {n_chunks} chunks in the best "
              "run")
    cuda0 = torch.device("cuda", 0)
    for huffman in (False, True):
        mode = "device_huffman" if huffman else "standard"
        run(f"{mode} round-robin [cuda:0, cuda:0]",
            DecodeConfig(device="cuda", device_huffman=huffman),
            [cuda0, cuda0])
    n_cards = torch.cuda.device_count()
    conf = DecodeConfig(device="cuda", multi_device=True)
    run(f"standard multi_device over {n_cards} visible card(s)", conf)
    _require((ne._decode_devices(conf) is None) == (n_cards == 1),
             f"multi_device on {n_cards} cards: {ne._decode_devices(conf)}")
    for narrow in (True, False):
        for huffman in (False, True):
            mode = "device_huffman" if huffman else "standard"
            run(f"{mode} drain_thread off, narrow readback "
                f"{'on' if narrow else 'off'}",
                DecodeConfig(device="cuda", device_huffman=huffman,
                             narrow_d2h=narrow, drain_thread=False))
    K1A_PATHS["modes"] = k1_total


def _stereo_kernels(stream):
    """K1a and the output stage on the stereo 192k disc's first chunk as
    the main path builds it (the parse of its frames, ``mp_pack``, 24-bit
    pack, narrow readback at tier 12): one substream of NB = 16 blocks of
    S = 80 samples (chains of 1,280 dependent steps), one 12-bit channel
    pair.  The main path's chunk program runs on it, then its redo at
    tier 16 and wide, with each kernel call held against its plain
    version on the same inputs, bit-exact on the card (K234n's flag rows
    included), and counted as one launch of its kernel from zeroed
    counts.  The chunk overflows the 12-bit tier, as the main path's redo
    needs.  Then K1a's and K234n's card times at this chunk."""
    import torch

    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.ops.chunk_filter import (chunk_filter,
                                                 chunk_filter_reference)
    from dvda_tpu_torch.ops.chunk_lanes import chunk_layout
    from dvda_tpu_torch.ops.rematrix import (output_stage,
                                             output_stage_reference)

    dev = torch.device("cuda", 0)
    fpc, S = STEREO["restart_every"], STEREO["block_size"]
    NB, L = STEREO["blocks_per_frame"] * fpc, STEREO["blocks_per_frame"] * S
    inc = ne.host.parse_mlp_stream_begin(stream)
    try:
        inc.step(fpc * STEREO_CHUNK + fpc)  # the first chunk's frames
        v = inc.view()
        _require(v.status == 0 and v.substream_count == 1,
                 "parse of the stereo chunk failed")
        arenas, spec = ne._build_chunk_arenas(
            v, [(v.sub[0], 0, S, NB, 0)], 0, STEREO_CHUNK, STEREO_CHUNK,
            NB * S, L, 2, 24, 0, 0,
            ne._max_matrix_slots(v.mat_active[:STEREO_CHUNK * fpc]),
            narrow=12)
    finally:
        inc.close()
    arenas = ne.arenas_to_device(*arenas, spec, dev)
    lay = chunk_layout(spec)
    _require([g[:2] for g in lay.groups] == [(NB, S)]
             and lay.subs[0][0] == STEREO_CHUNK,
             f"stereo chunk: filter launches {[g[:2] for g in lay.groups]}"
             f", {lay.subs[0][0]} chains")
    seen, calls = [], {}

    def k1a(*args, **kw):
        got = chunk_filter(*args, **kw)
        err = _max_err(got, chunk_filter_reference(*args, **kw))
        _require(err == 0, f"K1a stereo chunk: max |kernel - plain| = {err}")
        seen.append(("K1a", tuple(got.shape)))
        calls["K1a"] = args, kw
        return got

    def k234(*args, tier=0, **kw):
        calls[tier] = args, dict(kw, tier=tier)
        got = output_stage(*args, tier=tier, **kw)
        err = _max_err(got, output_stage_reference(*args, tier=tier, **kw))
        _require(err == 0, f"K234{'n' if tier else ''} stereo chunk tier "
                           f"{tier}: max |kernel - plain| = {err}")
        seen.append((tier, tuple(got.shape),
                     int(got[-1, -1].item()) if tier else None))
        return got

    _zero_launches()
    ne.chunk_filter, ne.output_stage = k1a, k234
    try:
        out, tier, redo = ne._chunk_program(*arenas, spec)
        redo(16)
        redo(0)
    finally:
        ne.chunk_filter, ne.output_stage = chunk_filter, output_stage
    torch.cuda.synchronize()
    launches = (chunk_filter.launches, output_stage.narrow_launches,
                output_stage.launches)
    _require(tier == 12 and [x[0] for x in seen] == ["K1a", 12, 16, 0]
             and launches == (1, 2, 1),
             f"stereo chunk: tier {tier}, calls {seen}, launches K1a, "
             f"K234n, K234 {launches}")
    flag12 = seen[1][2]
    _require(not flag12 & 1, f"stereo chunk: fits the 12-bit tier (flag "
                             f"{flag12}), so the main path would not redo it")
    print(f"[kernels] K1a mlp_filter_arena stereo 192k first chunk "
          f"({STEREO_CHUNK} chains, 1 substream, NB={NB} S={S}: "
          f"{NB * S} dependent steps; output {seen[0][1]}): bit-exact; "
          f"output stage on it, tier 12 {seen[1][1]} flag {flag12}, tier 16 "
          f"{seen[2][1]} flag {seen[2][2]}, wide {seen[3][1]}: bit-exact; "
          f"launches K1a {launches[0]}, K234n {launches[1]}, K234 "
          f"{launches[2]}")
    args, kw = calls["K1a"]
    ms, ev = _times(lambda: chunk_filter(*args, **kw), 20)
    args, kw = calls[12]
    out_ms, out_ev = _times(lambda: output_stage(*args, **kw), 20)
    print(f"[kernels] stereo 192k first chunk on the card: K1a {ms:.4f} ms "
          f"({ev:.4f} ms per call back to back; {ms * 1e6 / (NB * S):.1f} "
          f"ns per dependent step of {NB * S}), K234n tier 12 {out_ms:.4f} "
          f"ms ({out_ev:.4f} ms back to back)")


def phase_stereo(layout, smi: str):
    """The stereo 192k disc's first chunk through K1a and the output stage
    against their plain versions (:func:`_stereo_kernels`); then the disc
    through ``read_all_packed()`` on the card,
    printed with the [main] decodes (standard and device Huffman, narrow
    readback on and off) and the [modes] ones (the numpy arena builder,
    the drain without its side stream): each == host-complete, on the
    pipelined path in one section of 768-chain chunks, K1a once and K234
    once a chunk, K5 once a chunk in device Huffman, never K1; the track
    settled wide.  Read back narrow, the chunks pushed before the tier
    settled launch K234n at tier 12, overflow, and are run again wide
    (their K234), each counted in ``decode_native.mlp_chunks_redone``;
    the later chunks launch K234 at once."""
    import numpy as np

    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.codecs.mlp.track import assemble_track_stream
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.ops.chunk_filter import chunk_filter
    from dvda_tpu_torch.ops.chunk_lanes import chunk_lanes
    from dvda_tpu_torch.ops.huffman_decode import decode_residuals_device
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl
    from dvda_tpu_torch.ops.rematrix import output_stage

    reader = _open_track(layout, DecodeConfig(device="cuda"))
    stream, bnd, probe_end = assemble_track_stream(reader.aob,
                                                   reader.track.span)
    _stereo_kernels(stream)
    ref = ne.decode_host_complete(
        stream, bnd, probe_end, reader.parameters, True,
        DecodeConfig().resolved_parse_threads()).reshape(-1)
    n_chunks = -(-STEREO["n_frames"] // (STEREO["restart_every"]
                                         * STEREO_CHUNK))
    confs = {"[main] standard": {}, "[main] standard_wide":
             dict(narrow_d2h=False), "[main] device_huffman":
             dict(device_huffman=True), "[main] device_huffman_wide":
             dict(device_huffman=True, narrow_d2h=False),
             "[modes] standard native_pack off": dict(native_pack=False),
             "[modes] standard drain_thread off": dict(drain_thread=False)}
    k1a_total = 0
    for label, kw in confs.items():
        conf = DecodeConfig(device="cuda", **kw)
        narrow, huffman = conf.resolved_narrow_d2h(), conf.device_huffman
        _zero_launches()
        t = time.perf_counter()
        r = _open_track(layout, conf)
        out = r.read_all_packed()
        wall = time.perf_counter() - t
        info, counted = r.decode_info, ne.decode_native.mlp_chunks_redone
        k1a, k10 = chunk_filter.launches, chunk_lanes.launches
        k5 = decode_residuals_device.launches
        k234, k234n = output_stage.launches, output_stage.narrow_launches
        _require(np.array_equal(np.frombuffer(out, np.uint8), ref),
                 f"{label} stereo 192k: bytes differ from host-complete")
        _require((info["path"], info["sections"], info["chunks"])
                 == ("pipelined", 1, n_chunks)
                 and k1a == k234 == n_chunks
                 and mlp_filter_blocks_tl.launches == 0
                 and k234n == info["redone"]
                 and k10 == k5 == (n_chunks if huffman else 0),
                 f"{label} stereo 192k: {info['path']} path, "
                 f"{info['sections']} sections, {info['chunks']} chunks, "
                 f"launches K10 {k10}, K1a {k1a}, K5 {k5}, K234 {k234}, "
                 f"K234n {k234n}")
        _require(info["tier"] == 0 and counted == info["redone"]
                 and (info["redone"] >= 1) == narrow,
                 f"{label} stereo 192k: tier {info['tier']}, "
                 f"{info['redone']} chunks run again, {counted} counted")
        k1a_total += k1a
        print(f"{label} stereo 192k: == host-complete, {wall:.4f} s; "
              f"{info['chunks']} chunks of {STEREO_CHUNK} chains; launches "
              f"K10 {k10}, K1a {k1a}, K5 {k5}, K234 {k234}, K234n {k234n}; "
              f"tier {info['tier']}, {info['redone']} chunks run again "
              f"(mlp_chunks_redone {counted}), {info['drained']} bytes "
              f"drained; {smi}")
    K1A_PATHS["stereo"] = k1a_total


def phase_profile(layout, stream, smi: str):
    """One chunk program call (``uniform_arena_pipeline``) on the
    headline's first chunk, arenas on the card, under ``torch.profiler``
    in each mode: its card records must be the port's kernels only (no
    other kernel, no copy, no fill), and the launch counters K1a and
    K234n once and, in device Huffman, K10 once and K5 twice (no K1, and
    no K10 in standard mode).  Then one whole standard
    decode under the profiler, its records and idle share printed (not
    gated: the profiler has lost records on this card)."""
    import torch

    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.utils.profiling import (device_idle_share,
                                                kernel_counters)

    dev = torch.device("cuda", 0)
    ours = set(kernel_counters())
    for huffman in (False, True):
        mode = "device_huffman" if huffman else "standard"
        arenas, spec, words = _headline_chunk(stream, dev, huffman)

        def call():
            ne.uniform_arena_pipeline(*arenas, spec, words)

        for _ in range(2):  # the stream's narrow scratch, the layout
            call()
        torch.cuda.synchronize()
        _zero_launches()
        share, detail = device_idle_share(call)
        launched = _launched("mlp_filter_arena_kernel",
                             "output_stage_kernel")
        want = {"mlp_filter_arena_kernel": 1, "output_stage_kernel": 1}
        if huffman:
            want.update(chunk_lanes_kernel=1, huffman_decode_kernel=2)
        _require(launched == want, f"{mode} chunk program launched "
                                   f"{launched}, expected {want}")
        foreign = {k: n for k, n in detail["records"].items()
                   if k not in ours}
        _require(not foreign, f"{mode} chunk program: card records outside "
                              f"the port's kernels: {detail['records']}")
        print(f"[profile] {mode} chunk program, one call on the headline "
              f"chunk: records {detail['records']} (other 0), launches "
              f"{launched}; {detail['busy_ms']:.4f} ms busy in "
              f"{detail['wall_ms']:.3f} ms "
              f"({detail['reason'] or 'records agree with the counters'})")
    reader = _open_track(layout, DecodeConfig(device="cuda"))
    _zero_launches()
    share, detail = device_idle_share(reader.read_all_packed)
    print(f"[profile] standard decode (read_all_packed): idle share {share}, "
          f"{detail['busy_ms']:.3f} ms busy in {detail['wall_ms']:.2f} ms "
          f"wall (profiler on), records {detail['records']}, launches "
          f"{detail['launches']} ({detail['reason'] or 'records agree'}); "
          f"{smi}")


#: the hand-built unfused chunk at the headline's size: 256 chains of 8
#: frames of 80 samples, 5.1 in two substreams of different block
#: geometry (2 channels of 16 blocks x 40, 4 of 8 blocks x 80)
UNFUSED = dict(seed=21, Bc=CHUNK, L0=L0, fpc=8,
               geometry=((2, 16, 40), (4, 8, 80)))


def phase_unfused(smi: str):
    """A chunk whose substreams differ in block geometry (the synthesiser
    cannot make one; ``testutil.unfused_chunk_inputs`` builds its arenas
    by hand) through ``uniform_arena_pipeline`` on the card: one K1a
    launch per substream, each writing its lanes at their columns of the
    one series K234 reads; bit-exact against the plain chunk program;
    under the profiler 2 x K1a + K234 records only, equal to the
    counters; its card time."""
    import torch

    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.ops.chunk_filter import chunk_filter
    from dvda_tpu_torch.testutil import unfused_chunk_inputs

    arenas, spec = unfused_chunk_inputs(**UNFUSED)
    dev = torch.device("cuda", 0)
    a = ne.arenas_to_device(*arenas, spec, dev)
    _zero_launches()
    joined = chunk_filter.joined
    got = ne.uniform_arena_pipeline(*a, spec)
    torch.cuda.synchronize()
    launched = _launched("mlp_filter_arena_kernel", "output_stage_kernel")
    want = {"mlp_filter_arena_kernel": 2, "output_stage_kernel": 1}
    _require(launched == want and chunk_filter.joined == joined + 1,
             f"the unfused chunk launched {launched}, expected {want}")
    K1A_PATHS["unfused chunk"] = launched["mlp_filter_arena_kernel"]
    plain = ne.uniform_arena_pipeline(
        *ne.arenas_to_device(*arenas, spec, "cpu"), spec)
    err = _max_err(got.cpu(), plain)
    _require(err == 0, f"the unfused chunk: max |card - plain| = {err}")
    kinds = _records_only("unfused", want, "the unfused chunk")
    ms, ev = _times(lambda: ne.uniform_arena_pipeline(*a, spec), 20)
    print(f"[unfused] {smi}; chunk of {UNFUSED['Bc']} chains, substreams "
          f"(n_ch, NB0, S0) {UNFUSED['geometry']}: launches {launched}, "
          f"each K1a at its columns of one series; == the plain chunk "
          f"program ({tuple(got.shape)} bytes); under the profiler records "
          f"{kinds} == launches, no copy; {ms:.4f} ms on the "
          f"card ({ev:.4f} ms per call back to back)")


def phase_tiers(smi: str):
    """The three-tier streams through the port on the card, narrow
    readback on and off, in both modes: equal to each other and to
    host-complete; the tiers settle at 12 (quiet), 16 (mid), 0 (loud)."""
    import numpy as np

    from dvda_tpu_torch.codecs.mlp.native_engine import (decode_host_complete,
                                                         decode_native)
    from dvda_tpu_torch.codecs.params import StreamParameters
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.ops.rematrix import output_stage
    from dvda_tpu_torch.testutil import (BPS_CODE, RATE_CODE, MlpSynthConfig,
                                         synth_mlp_stream)

    bnd = np.zeros(0, np.int64)
    settled = {}
    for kind, (shifts, tier) in TIER_STREAMS.items():
        cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                             n_frames=24, seed=11, out_shift_range=shifts)
        stream = synth_mlp_stream(cfg)
        params = StreamParameters(BPS_CODE[24], 0xF,
                                  RATE_CODE[cfg.sample_rate], 0xF, 17)
        ref = decode_host_complete(stream, bnd, len(stream), params, True)
        for huffman in (False, True):
            for narrow in (True, False):
                info = {}
                before = output_stage.narrow_launches
                out = decode_native(stream, bnd, len(stream), params, True,
                                    DecodeConfig(device="cuda",
                                                 device_huffman=huffman,
                                                 narrow_d2h=narrow),
                                    info=info)
                label = (f"{kind} {'device_huffman' if huffman else 'standard'}"
                         f" narrow {'on' if narrow else 'off'}")
                _require(np.array_equal(out, ref),
                         f"{label}: bytes differ from host-complete")
                _require(info["tier"] == (tier if narrow else 0),
                         f"{label}: settled at tier {info['tier']}")
                _require((output_stage.narrow_launches > before) == narrow,
                         f"{label}: K234n launches did not follow the knob")
                settled[label] = (info["tier"], info["redone"],
                                  info["drained"])
    print(f"[tiers] quiet, mid, loud 24-bit streams (24 frames, seed 11), "
          f"narrow on and off, both modes: == host-complete; {smi}")
    for label, (tier, redone, drained) in settled.items():
        print(f"[tiers]   {label}: tier {tier}, {redone} chunks run again, "
              f"{drained} bytes drained")


class _Timed:
    """A sector hook that sums the seconds spent in it."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, sectors):
        t = time.perf_counter()
        out = self.fn(sectors)
        self.seconds += time.perf_counter() - t
        self.calls += 1
        return out


def phase_cppm(plain, enc_path: str, n_sectors: int, smi: str):
    """The encrypted three-track disc through the port on the card, and
    the plaintext copy through ``disc_to_wavs``; byte-compared with the
    port's C++ host path; walls against the host path (host C2)."""
    import torch

    import dvda_tpu_torch
    from dvda_tpu_torch import host
    from dvda_tpu_torch.api import TrackReader
    from dvda_tpu_torch.batch import disc_to_wavs
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.container.aob import AOBReader
    from dvda_tpu_torch.cppm.decrypt import CppmDecryptor
    from dvda_tpu_torch.ops.c2_decrypt import decrypt_sectors_device
    from dvda_tpu_torch.ops.chunk_filter import chunk_filter
    from dvda_tpu_torch.ops.pcm_unpack import decode_chunks_device
    from dvda_tpu_torch.ops.rematrix import output_stage
    from dvda_tpu_torch.testutil import host_track_bytes
    from dvda_tpu_torch.utils.profiling import global_timer
    from dvda_tpu_torch.utils.wav import pack_samples_le, wave_header

    conf = DecodeConfig(device="cuda")
    counters = {"c2_decrypt": decrypt_sectors_device,
                "pcm_unpack": decode_chunks_device,
                "mlp_filter_arena": chunk_filter,
                "output_stage": output_stage}
    title = (dvda_tpu_torch.open_disc(enc_path, config=conf).open_titleset(1)
             .open_title(1))
    tracks = [title.open_track(n) for n in (1, 2, 3)]
    port_hook = _Timed(CppmDecryptor(MEDIA_KEY, ALBUM,
                                     config=conf).decrypt_sectors)

    def host_c2(sectors):
        out = sectors.copy()
        host.c2_decrypt_sectors(out, MEDIA_KEY, ALBUM, False)
        return out

    host_hook = _Timed(host_c2)
    threads = conf.resolved_parse_threads()

    def port(track):
        reader = TrackReader(AOBReader(enc_path, 1, decrypt=port_hook),
                             track, config=conf)
        out = reader.read_all_packed()
        torch.cuda.synchronize()
        return out, reader

    def host_path(track):
        return host_track_bytes(AOBReader(enc_path, 1, decrypt=host_hook),
                                track, threads)

    walks = TrackReader._pcm_on_device
    for fn in counters.values():
        fn.launches = 0
    output_stage.narrow_launches = 0
    walks.pcm_walks_in_place = walks.pcm_walks_staged = 0
    walks.pcm_readbacks_pinned = walks.pcm_readbacks_pageable = 0
    got, readers = zip(*(port(t) for t in tracks))
    wav_dir = os.path.join(os.path.dirname(os.path.dirname(enc_path)),
                           "wavs")
    written = disc_to_wavs(plain.path, wav_dir, config=conf)
    samples = {n: TrackReader(AOBReader(enc_path, 1, decrypt=port_hook),
                              t, config=conf).read_all()
               for n, (t, r) in enumerate(zip(tracks, readers), 1)
               if r.codec == "PCM"}
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["output_stage_narrow"] = output_stage.narrow_launches
    # each PCM track decoded packed twice (the port, then disc_to_wavs)
    # and int32 once, every time K8 reading the walk's own pinned buffer;
    # the packed output read back into that buffer, the int32 to pageable
    pcm_packed, pcm_int32 = 2 * len(samples), len(samples)
    _require(walks.pcm_walks_in_place == pcm_packed + pcm_int32
             and walks.pcm_walks_staged == 0,
             f"the PCM walks: {walks.pcm_walks_in_place} in place, "
             f"{walks.pcm_walks_staged} staged, of "
             f"{pcm_packed + pcm_int32} decodes")
    _require(walks.pcm_readbacks_pinned == pcm_packed
             and walks.pcm_readbacks_pageable == pcm_int32,
             f"the PCM readbacks: {walks.pcm_readbacks_pinned} pinned of "
             f"{pcm_packed} packed decodes, {walks.pcm_readbacks_pageable} "
             f"pageable of {pcm_int32} int32 ones")
    K1A_PATHS["cppm"] = launches["mlp_filter_arena"]
    # the MLP track reads back narrow (the default): K234n, not K234
    _require(launches["c2_decrypt"] >= 10 and launches["pcm_unpack"] >= 2
             and launches["mlp_filter_arena"] >= 18
             and launches["output_stage_narrow"] >= 18,
             f"the CPPM disc phase did not run its kernels: {launches}")

    # the host path's references on the plaintext disc
    ptitle = (dvda_tpu_torch.open_disc(plain.path, config=conf)
              .open_titleset(1).open_title(1))
    want = [host_track_bytes(AOBReader(plain.path, 1), ptitle.open_track(n),
                             threads) for n in (1, 2, 3)]
    sizes = (SECONDS * 96000 * 6 * 3, SECONDS * 96000 * 6 * 3,
             SECONDS * 48000 * 2 * 2)
    for n, (g, w, size, r) in enumerate(zip(got, want, sizes, readers), 1):
        _require(len(w) == size, f"track {n}: host path gave {len(w)} "
                                 f"bytes, expected {size}")
        _require(g == w, f"track {n} ({r.codec}): port bytes differ from "
                         "the host path")
        _require(n not in samples or pack_samples_le(
            samples[n], r.bits_per_sample) == w,
            f"track {n}: the int32 decode differs from the host path")
        with open(written[n - 1], "rb") as f:
            wav = f.read()
        hdr = wave_header(r.sample_rate, r.channel_count, r.channel_mask,
                          r.bits_per_sample, len(w) * 8 // (
                              r.channel_count * r.bits_per_sample))
        _require(os.path.basename(written[n - 1]) == f"track-01-0{n}.wav"
                 and wav == hdr + w, f"disc_to_wavs: {written[n - 1]} "
                                     "differs from header + host bytes")
    print(f"[cppm] encrypted disc, 3 tracks through the port on the card == "
          f"the host path on the plaintext disc ({sum(sizes)} bytes); "
          f"disc_to_wavs on the plaintext copy: 3 WAVs identical; "
          f"read_all() of the {pcm_int32} PCM tracks identical")
    print(f"[cppm] launches {launches}; PCM walks in place "
          f"{walks.pcm_walks_in_place}, staged {walks.pcm_walks_staged}; "
          f"readbacks pinned {walks.pcm_readbacks_pinned}, pageable "
          f"{walks.pcm_readbacks_pageable}")

    # walls: best of 3, port and host path interleaved, per track
    print(f"[cppm] {smi}; {n_sectors} sectors, per track best of 3 "
          f"interleaved (decrypt = seconds inside the sector hook; stages "
          f"of the port's best run, the PCM unpack stage = h2d from the "
          f"walk's pinned buffer, K8, d2h):")
    for n, track in enumerate(tracks, 1):
        best = {}
        for _ in range(3):
            for who, run, hook in (("port", lambda: port(track)[0],
                                    port_hook),
                                   ("host", lambda: host_path(track),
                                    host_hook)):
                hook.seconds, hook.calls = 0.0, 0
                global_timer.reset()
                t = time.perf_counter()
                out = run()
                dt = time.perf_counter() - t
                _require(out == want[n - 1], f"track {n} {who}: bytes differ")
                if who not in best or dt < best[who][0]:
                    best[who] = (dt, hook.seconds, hook.calls,
                                 dict(global_timer.totals))
        r = readers[n - 1]
        desc = (f"{r.codec} {r.channel_count} ch {r.sample_rate // 1000}k/"
                f"{r.bits_per_sample}")
        stages = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                          sorted(best["port"][3].items()))
        print(f"[cppm]   track {n} {desc}: port {best['port'][0]:.4f} s "
              f"(decrypt {best['port'][1]:.4f} s in {best['port'][2]} K7 "
              f"round trips), host {best['host'][0]:.4f} s (host C2 "
              f"{best['host'][1]:.4f} s in {best['host'][2]} calls); "
              f"{SECONDS / best['port'][0]:.1f}x / "
              f"{SECONDS / best['host'][0]:.1f}x realtime; port stages "
              f"{stages}")
    return {k: launches[k] for k in ("c2_decrypt", "pcm_unpack")}


def phase_synth_general(work: str):
    """The general-path disc: 12 sections of 2.5 s alternating 2 x 40 and
    4 x 20 samples per frame (layout, total PCM frames)."""
    from dvda_tpu_torch.testutil import (MlpSynthConfig, MlpTrackSpec,
                                         build_disc, synth_mlp_stream)

    t0 = time.perf_counter()
    cfgs = [MlpSynthConfig(blocks_per_frame=4 if i % 2 else 2,
                           block_size=20 if i % 2 else 40, seed=40 + i,
                           **GENERAL) for i in range(SECTIONS)]
    stream = b"".join(synth_mlp_stream(c) for c in cfgs)
    frames = sum(c.total_pcm_frames for c in cfgs)
    spec = MlpTrackSpec(mlp_stream=stream, pcm_frames=frames,
                        sample_rate=GENERAL["sample_rate"],
                        channel_assignment=GENERAL["channel_assignment"])
    layout = build_disc(os.path.join(work, "general", "AUDIO_TS"), [[spec]])
    print(f"[synth] general disc: {SECTIONS} sections, {frames} frames of "
          f"5.1/96k/24, {len(stream) / 1e6:.2f} MB MLP stream in "
          f"{time.perf_counter() - t0:.1f} s")
    return layout, frames


def _k6a_take(u):
    """K6a's residual gather as one ``torch.take``: the residuals with a
    zero appended, and the source of every element of K1's ``[NB, S, B]``
    input (the appended zero past a block's length)."""
    import torch

    n_ch = u["shift"].shape[1]
    bidx = u["bidx"].long()
    dev = bidx.device
    blk = bidx.repeat_interleave(n_ch, 0)                      # [B, NB]
    c = torch.arange(n_ch, device=dev).repeat(bidx.shape[0])[:, None]
    lens = u["lens"].long()[blk]
    s = torch.arange(u["S"], device=dev)
    at = (u["res_off"][blk] + c * lens)[:, :, None] + s        # [B, NB, S]
    at = torch.where(s < lens[:, :, None], at, u["res"].numel())
    return (torch.cat([u["res"], u["res"].new_zeros(1)]),
            at.permute(1, 2, 0).contiguous())


def _kernels_k6(subs, tabs, F: int, hc32, smi: str):
    """K6a (both substreams: the main path's two launches) and K6b against
    their plain versions on the general disc's tables; K6a's residual
    gather against ``torch.take`` and K6a + K1 + K6b against host-complete.
    Their kernel records."""
    import numpy as np
    import torch

    from dvda_tpu_torch.ops.general_gather import (lane_pack,
                                                   lane_pack_reference,
                                                   series_remix,
                                                   series_remix_reference)
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl
    from dvda_tpu_torch.testutil import (LANE_PACK_EDGES, SERIES_REMIX_EDGES,
                                         general_inputs)

    err = 0
    packed = []
    for u in subs:
        got = lane_pack(u)
        ref = lane_pack_reference(u)
        torch.cuda.synchronize()
        e = max(_max_err(g, r) for g, r in zip(got, ref, strict=True))
        _require(e == 0, f"K6a: max |kernel - plain| = {e}")
        err = max(err, e)
        packed.append(got)
        res0, at = _k6a_take(u)
        _require(torch.equal(res0.take(at), got[0]),
                 "K6a: torch.take differs from the kernel")
    shapes = [tuple(p[0].shape) for p in packed]
    print(f"[general] K6a lane_pack, K1 inputs [NB, S, B] {shapes}: "
          "bit-exact")
    # ragged tiles: lane counts off the 128-lane tile, every substream width
    dev = subs[0]["res"].device
    lanes = []
    for n_ch, S, n_blocks, extreme in LANE_PACK_EDGES:
        (u,), _ = general_inputs(0, n_blocks=n_blocks, S=S, n_ch=(n_ch,),
                                 extreme=extreme)
        u = {k: v if k == "S" else torch.from_numpy(v).to(dev)
             for k, v in u.items()}
        e = max(_max_err(g, r) for g, r in zip(
            lane_pack(u), lane_pack_reference(u), strict=True))
        _require(e == 0, f"K6a {n_ch} ch, S={S}: max |kernel - plain| = {e}")
        lanes.append(f"{u['bidx'].shape[0] * n_ch} lanes of {n_ch} ch, S={S}")
    print(f"[general] K6a edge shapes ({'; '.join(lanes)}): bit-exact")

    def k6a():
        for u in subs:
            lane_pack(u)

    def k6a_plain():
        for u in subs:
            lane_pack_reference(u)

    takes = [_k6a_take(u) for u in subs]

    def k6a_take():
        for res0, at in takes:
            res0.take(at)

    k6a_ms, k6a_ev = _times(k6a, 20)
    k6a_plain_ms = events_ms(k6a_plain, 2)
    take_ms, take_ev = _times(k6a_take, 20)
    # inputs: the parse's tables; outputs: K1's nine arguments.  About 8
    # integer operations per output element (index arithmetic, select)
    n_out = sum(t.numel() for p in packed for t in p)
    k6a_rec = _record(err, k6a_ms, k6a_plain_ms,
                      _nbytes(*(t for u in subs for k, t in u.items()
                                if k != "series_idx"),
                              *(t for p in packed for t in p)),
                      8 * n_out, take_ms)
    print(f"[general] {smi}; K6a both substreams: kernel {k6a_ms:.4f} ms, "
          f"torch.take (residuals only) {take_ms:.4f} ms on the card "
          f"({k6a_ev:.4f} / {take_ev:.4f} ms per call back to back), bound "
          f"{k6a_rec['bound_ms']:.4f} ms, plain {k6a_plain_ms:.2f} ms per "
          "call")

    # K6b on K1's outputs of those inputs
    outs = [(mlp_filter_blocks_tl(*p[:8], p[8], p[8])[0], u["series_idx"],
             u["shift"].shape[1]) for p, u in zip(packed, subs)]
    y = series_remix(outs, *tabs)
    y_ref = series_remix_reference(outs, *tabs)
    torch.cuda.synchronize()
    e6b = _max_err(y, y_ref)
    _require(e6b == 0, f"K6b: max |kernel - plain| = {e6b}")
    _require(np.array_equal(y.cpu().numpy(), hc32),
             "K6a + K1 + K6b differ from the host-complete reconstruction")
    print(f"[general] K6b series_remix [T, C] = {tuple(y.shape)}: bit-exact, "
          "and equal to host-complete")
    # its tiles' edges, on full-range K1 outputs
    gen = torch.Generator(device="cpu").manual_seed(0)
    for name, n_ch, n_blocks, S, extreme, starts in SERIES_REMIX_EDGES:
        esubs, eframes = general_inputs(0, n_blocks=n_blocks, S=S, n_ch=n_ch,
                                        extreme=extreme, frame_starts=starts)
        eframes = [torch.from_numpy(f).to(dev) for f in eframes]
        eouts = [(torch.randint(-2**31, 2**31 - 1, (
            u["bidx"].shape[1], u["S"], u["bidx"].shape[0] * nc),
            generator=gen, dtype=torch.int32).to(dev),
            torch.from_numpy(u["series_idx"]).to(dev), nc)
            for u, nc in zip(esubs, n_ch)]
        e = _max_err(series_remix(eouts, *eframes),
                     series_remix_reference(eouts, *eframes))
        _require(e == 0, f"K6b edge case {name}: max |kernel - plain| = {e}")
    print("[general] K6b edge cases ("
          + ", ".join(e[0] for e in SERIES_REMIX_EDGES) + "): bit-exact")
    k6b_ms, k6b_ev = _times(lambda: series_remix(outs, *tabs), 20)
    k6b_plain_ms = events_ms(lambda: series_remix_reference(outs, *tabs), 2)
    # per sample: the frame search (~3 operations per step), 6 matrices x
    # (10 multiply-adds, shift, mask, add), per output channel its pick
    # and shift.  Of each K1 output only the T x n_ch live samples are
    # read (the rest is chain and block padding no series index reaches)
    T, out_ch = y.shape
    ops = T * (3 * int(np.ceil(np.log2(F + 1))) + 6 * 24 + out_ch * 4)
    k6b_rec = _record(e6b, k6b_ms, k6b_plain_ms,
                      sum(4 * T * n for _, _, n in outs)
                      + _nbytes(*(o[1] for o in outs), *tabs, y), ops)
    print(f"[general] {smi}; K6b: kernel {k6b_ms:.4f} ms on the card "
          f"({k6b_ev:.4f} ms per call back to back), plain "
          f"{k6b_plain_ms:.2f} ms per call")
    # K1 at the churn disc's widest substream (K6a's outputs as its inputs)
    p = max(packed, key=lambda p: p[0].shape[2])
    NB, S, B = p[0].shape
    k1_ms, k1_ev = _times(lambda: mlp_filter_blocks_tl(*p[:8], p[8], p[8]),
                          20)
    print(f"[general] {smi}; K1 at the churn substream [NB, S, B] = "
          f"{NB, S, B}: kernel {k1_ms:.4f} ms on the card ({k1_ev:.4f} ms "
          f"per call back to back; {k1_ms * 1e6 / (NB * S):.1f} ns per "
          f"dependent step of {NB * S})")
    return {"lane_pack": k6a_rec, "series_remix": k6b_rec}


def phase_general(layout, frames: int, smi: str):
    """The general path on the card: K6a and K6b against their plain
    versions at the disc's shapes, then the disc through the reader API,
    which must take the general path; walls against host-complete."""
    import numpy as np
    import torch

    import dvda_tpu_torch
    from dvda_tpu_torch import host
    from dvda_tpu_torch.codecs.mlp import native_engine as ne
    from dvda_tpu_torch.codecs.mlp.track import assemble_track_stream
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.container.aob import AOBReader
    from dvda_tpu_torch.ops.general_gather import lane_pack, series_remix
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl
    from dvda_tpu_torch.testutil import host_track_bytes
    from dvda_tpu_torch.utils.profiling import global_timer

    dev = torch.device("cuda", 0)
    conf = DecodeConfig(device="cuda")
    threads = conf.resolved_parse_threads()
    reader = (dvda_tpu_torch.open_disc(layout.path, config=conf)
              .open_titleset(1).open_title(1).open_track(1).open_reader())
    stream, bnd, probe_end = assemble_track_stream(reader.aob,
                                                   reader.track.span)
    params = reader.parameters
    hc32 = ne.decode_host_complete(stream, bnd, probe_end, params, False,
                                   threads)
    T, out_ch = hc32.shape
    _require(T == frames and out_ch == 6,
             f"host-complete gave {hc32.shape}, expected ({frames}, 6)")

    # the general path's tables, as _decode_parsed builds them (views of
    # the parse on the CPU: it stays open while they are used)
    inc = host.parse_mlp_stream_begin(stream, threads=threads)
    try:
        inc.step(0)
        v = inc.view()
        _require(v.status == 0, "the general disc's parse bailed")
        F = ne._frame_cut(v.frame_end, np.asarray(bnd, dtype=np.int64),
                          probe_end)
        records = _kernels_k6(*ne.general_tables(v, F, T, out_ch, dev), F,
                              hc32, smi)
    finally:
        inc.close()

    # the main path: the disc through the reader API on the card
    counters = {"lane_pack": lane_pack, "series_remix": series_remix,
                "mlp_filter": mlp_filter_blocks_tl}

    def port():
        r = (dvda_tpu_torch.open_disc(layout.path, config=conf)
             .open_titleset(1).open_title(1).open_track(1).open_reader())
        out = r.read_all_packed()
        torch.cuda.synchronize()
        _require(r.decode_info.get("path") == "general",
                 f"the disc took the {r.decode_info.get('path')} path")
        return out

    for fn in counters.values():
        fn.launches = 0
    got = port()
    launches = {k: fn.launches for k, fn in counters.items()}
    K1_PATHS["churn"] = launches["mlp_filter"]
    _require(launches["lane_pack"] == 2 and launches["series_remix"] == 1
             and launches["mlp_filter"] >= 2,
             f"the general disc did not run its kernels: {launches}")
    want = hc32.shape[0] * out_ch * 3

    def host_path():
        return host_track_bytes(AOBReader(layout.path, 1), reader.track,
                                threads)

    ref = host_path()
    _require(len(ref) == want and got == ref,
             f"general path: {len(got)} port bytes differ from the "
             f"{len(ref)} host-complete bytes")
    print(f"[general] read_all_packed took the general path, launches "
          f"{launches}; == host-complete: {want} bytes identical")

    def decode():  # the decode alone, from the assembled stream
        info = {}
        out = ne.decode_native(stream, bnd, probe_end, params, True, conf,
                               info=info)
        torch.cuda.synchronize()
        _require(info["path"] == "general",
                 f"decode_native took the {info['path']} path")
        return out

    def same_bytes(out):
        return out == ref

    def same_samples(out):
        return out.dtype == hc32.dtype and np.array_equal(out, hc32)

    runs = {"port": (port, same_bytes), "decode": (decode, same_samples),
            "host": (host_path, same_bytes)}
    times = {who: [] for who in runs}
    stages = {}
    for _ in range(3):
        for who, (run, same) in runs.items():
            global_timer.reset()
            t = time.perf_counter()
            out = run()
            dt = time.perf_counter() - t
            _require(same(out), f"general {who}: output differs")
            if not times[who] or dt < min(times[who]):
                stages[who] = dict(global_timer.totals)
            times[who].append(dt)
    print(f"[general] {smi}; best of 3 interleaved, {threads} parse "
          "threads; port and host from the disc (read_all_packed, the host "
          "path), decode = decode_native on the assembled stream:")
    for who, ts in times.items():
        timers = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                          sorted(stages[who].items()))
        print(f"[general]   {who}: {min(ts):.4f} s = "
              f"{SECONDS / min(ts):.1f}x realtime (runs "
              f"{', '.join(f'{x:.4f}' for x in ts)}); stages {timers}")
    return records, {k: launches[k] for k in ("lane_pack", "series_remix")}


def _plain_step(b):
    """decode_step built from the plain versions: K1's and K9's."""
    from dvda_tpu_torch.ops.mlp_filter import mlp_filter_blocks_tl_reference

    F, C, NB, S = b.residuals.shape

    def flat(x):
        return x.reshape((F * C,) + tuple(x.shape[2:]))

    zeros = b.residuals.new_zeros((F * C, 8))
    out = mlp_filter_blocks_tl_reference(
        flat(b.residuals).permute(1, 2, 0).contiguous(), flat(b.rc_fir),
        flat(b.rc_iir), flat(b.shift), flat(b.quant), flat(b.iir_reset),
        flat(b.iir_init), flat(b.block_len), zeros, zeros)[0]
    channels = out.permute(2, 0, 1).reshape(F, C, NB * S).transpose(1, 2)
    return _k9_plain([channels, b.noise, b.mat_coeff, b.mat_noise, b.mat_out,
                      b.mat_active, b.mat_quant, b.bypassed, b.output_shift,
                      b.wave_perm], 6)


def phase_step(smi: str):
    """The fused decode step on the card and its sharded form; one step
    under the profiler: K1 and K9 only."""
    import torch

    from dvda_tpu_torch.ops.mlp_filter import (mlp_filter_blocks_tl,
                                               mlp_filter_frames)
    from dvda_tpu_torch.ops.rematrix import frame_remix
    from dvda_tpu_torch.parallel.mesh import make_mesh
    from dvda_tpu_torch.parallel.step import (decode_step, example_batch,
                                              make_sharded_step)

    dev = torch.device(DEV)
    b = example_batch(device=dev, **STEP)
    counters = {"mlp_filter": mlp_filter_blocks_tl,
                "frame_remix": frame_remix}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.set_sync_debug_mode("error")  # a step never waits on the card
    try:
        got = decode_step(b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    K1_PATHS["step"] = launches["mlp_filter"]
    _require(launches == {"mlp_filter": 1, "frame_remix": 1},
             f"decode_step did not run K1 and K9 once each: {launches}")
    F, L = STEP["F"], STEP["NB"] * STEP["S"]
    _require(tuple(got.shape) == (F, L, STEP["C_out"]),
             f"decode_step gave {tuple(got.shape)}")
    err = _max_err(got, _plain_step(b))
    _require(err == 0, f"decode_step: max |kernels - plain| = {err}")
    mesh = make_mesh()
    sharded = make_sharded_step(mesh)(b)
    torch.cuda.synchronize()
    _require(torch.equal(sharded, got),
             "make_sharded_step differs from decode_step")
    # one step under the profiler: its card records are K1 and K9 only
    # (no copy, fill or other kernel), equal to the counters
    kinds = _records_only("step", {"mlp_filter_kernel": 1,
                                   "frame_remix_kernel": 1},
                          "a profiled decode_step")
    print(f"[step] one decode_step under the profiler: records {kinds} == "
          "launches, no copy, fill or other kernel")
    # K1 alone at the step's lanes (the flat inputs decode_step builds)
    F, C, NB, S = b.residuals.shape

    def flat(x):
        return x.reshape((F * C,) + tuple(x.shape[2:]))

    zeros = b.residuals.new_zeros((F * C, 8))
    k1_args = (flat(b.residuals).permute(1, 2, 0).contiguous(),
               *(flat(getattr(b, k)).contiguous() for k in (
                   "rc_fir", "rc_iir", "shift", "quant", "iir_reset",
                   "iir_init", "block_len")), zeros, zeros)
    k1_ms, k1_ev = _times(lambda: mlp_filter_blocks_tl(*k1_args), 20)
    lanes = [getattr(b, k) for k in ("residuals", "rc_fir", "rc_iir",
                                     "shift", "quant", "iir_reset",
                                     "iir_init", "block_len")]
    fm_ms, fm_ev = _times(lambda: mlp_filter_frames(*lanes), 20)
    print(f"[step] {smi}; K1 at the step's [NB, S, B] = {NB, S, F * C}: "
          f"time-leading {k1_ms:.4f} ms on the card ({k1_ev:.4f} ms per "
          f"call back to back; {k1_ms * 1e6 / (NB * S):.1f} ns per "
          f"dependent step of {NB * S}); frame-major on the batch's own "
          f"[F, C, NB, S] residuals (the step's K1) {fm_ms:.4f} ms "
          f"({fm_ev:.4f} back to back)")
    for _ in range(3):
        decode_step(b)
    card_ms = device_ms(lambda: decode_step(b), 20)
    t = time.perf_counter()
    ms = events_ms(lambda: decode_step(b), 20)
    wall_ms = (time.perf_counter() - t) * 1e3 / 20
    print(f"[step] decode_step F={F} C={STEP['C']} NB={STEP['NB']} "
          f"S={STEP['S']} ({F * STEP['C']} K1 lanes, L={L}): launches "
          f"{launches}; bit-exact against the plain versions; "
          f"make_sharded_step over a {mesh.devices.shape} grid equal")
    print(f"[step] {smi}; decode_step {ms:.4f} ms per step (CUDA events "
          "over 20 steps queued back to back, no synchronisation inside a "
          f"step); host wall {wall_ms:.4f} ms per step (the final "
          f"synchronisation included); card time {card_ms:.4f} ms per step "
          "(20 steps queued behind a spin)")


def phase_synth_engine(work: str, n_frames: int, name: str, **kw):
    """A headline-format disc of ``n_frames`` frames: (layout, stream)."""
    from dvda_tpu_torch.testutil import (MlpSynthConfig, MlpTrackSpec,
                                         build_disc, synth_mlp_stream)

    t0 = time.perf_counter()
    cfg = MlpSynthConfig(**dict(HEADLINE, n_frames=n_frames, **kw))
    stream = synth_mlp_stream(cfg)
    if name == "bail":
        # frame 8 (a restart frame) damaged in a stream without check data:
        # the native parser and the planner both hand it back
        stream = bytearray(stream)
        off = 0
        for _ in range(8):
            off += (((stream[off] & 0x0F) << 8) | stream[off + 1]) * 2
        stream[off + 114] ^= 0x5A
        stream = bytes(stream)
    spec = MlpTrackSpec(mlp_stream=stream, pcm_frames=cfg.total_pcm_frames,
                        sample_rate=cfg.sample_rate,
                        channel_assignment=cfg.channel_assignment)
    layout = build_disc(os.path.join(work, name, "AUDIO_TS"), [[spec]])
    print(f"[synth] {name} disc: {n_frames} frames of 5.1/96k/24 "
          f"({cfg.total_pcm_frames / cfg.sample_rate:.1f} s), "
          f"{len(stream) / 1e6:.2f} MB MLP stream in "
          f"{time.perf_counter() - t0:.1f} s")
    return layout


def _open_track(layout, conf):
    import dvda_tpu_torch

    return (dvda_tpu_torch.open_disc(layout.path, config=conf)
            .open_titleset(1).open_title(1).open_track(1).open_reader())


def phase_engine(layout, smi: str):
    """The Python engine on the card: the disc through the reader API with
    ``use_native=False``; == host-complete; K9 at the engine's inputs."""
    import torch

    from dvda_tpu_torch.codecs.mlp import engine
    from dvda_tpu_torch.codecs.mlp.native_engine import decode_host_complete
    from dvda_tpu_torch.codecs.mlp.track import assemble_track_stream
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.ops.mlp_filter import (mlp_filter_blocks_tl,
                                               mlp_filter_blocks_tl_reference)
    from dvda_tpu_torch.ops.rematrix import frame_remix
    from dvda_tpu_torch.utils.profiling import global_timer

    filter_lanes = engine.filter_lanes
    conf = DecodeConfig(device=DEV, use_native=False)
    captured, filtered = [], []

    def capture(*args, **kw):  # the engine's K9 arguments, for the check
        captured.append((args, kw))
        return frame_remix(*args, **kw)

    def capture_k1(lanes, device):  # the engine's filter call: its host
        res = filter_lanes(lanes, device)  # arrays and K1's results
        filtered.append(([x.copy() for x in lanes], res))
        return res

    counters = {"mlp_filter": mlp_filter_blocks_tl,
                "frame_remix": frame_remix}
    engine.frame_remix = capture
    engine.filter_lanes = capture_k1
    try:
        reader = _open_track(layout, conf)
        for fn in counters.values():
            fn.launches = 0
        global_timer.reset()
        t = time.perf_counter()
        got = reader.read_all_packed()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: fn.launches for k, fn in counters.items()}
        stages = dict(global_timer.totals)
    finally:
        engine.frame_remix = frame_remix
        engine.filter_lanes = filter_lanes
    _require(reader.decode_info.get("path") == "engine",
             f"the engine disc took the {reader.decode_info} path")
    K1_PATHS["engine"] = launches["mlp_filter"]
    _require(launches["mlp_filter"] >= 1 and launches["frame_remix"] >= 1,
             f"the engine disc did not run K1 and K9: {launches}")
    stream, bnd, probe_end = assemble_track_stream(reader.aob,
                                                   reader.track.span)
    threads = conf.resolved_parse_threads()
    t = time.perf_counter()
    ref = decode_host_complete(stream, bnd, probe_end, reader.parameters,
                               True, threads).tobytes()
    host_wall = time.perf_counter() - t
    want = ENGINE_FRAMES * L0 * 6 * 3
    _require(len(ref) == want and got == ref,
             f"engine: {len(got)} port bytes differ from the {len(ref)} "
             "host-complete bytes")
    # K1 at the engine's shapes, against its plain version on the same
    # (transposed) inputs from zero states, tolerance 0: output and final
    # states
    k1_err, lanes = 0, []
    for host, (out, fir_f, iir_f) in filtered:
        args = [torch.from_numpy(x).to(DEV) for x in host]
        ref = mlp_filter_blocks_tl_reference(args[0].permute(1, 2, 0),
                                             *args[1:], None, None)
        k1_err = max(k1_err, _max_err(out, ref[0].permute(2, 0, 1)),
                     _max_err(fir_f, ref[1]), _max_err(iir_f, ref[2]))
        lanes.append(tuple(args[0].shape))
    _require(bool(filtered) and k1_err == 0,
             f"engine K1: max |kernel - plain| = {k1_err} over {lanes}")
    print(f"[engine] read_all_packed(use_native=False) took the engine "
          f"path, launches {launches}; == host-complete: {want} bytes "
          f"identical; K1 at the engine's [B, NB, S] = {lanes} bit-exact "
          "against its plain version (output and final states)")
    _engine_filter_records(filtered[0][0])
    (args, kw), = captured
    rec = _k9_check(list(args), kw.get("n_mats", 6), "engine disc", reps=20)
    seconds = ENGINE_FRAMES * L0 / HEADLINE["sample_rate"]
    timers = " ".join(f"{k}={v * 1e3:.1f}ms" for k, v in
                      sorted(stages.items()))
    plan = stages.get("mlp/plan", 0.0)
    print(f"[engine] {smi}; {seconds:.2f} s disc: engine {wall:.4f} s = "
          f"{seconds / wall:.2f}x realtime (planner {plan:.4f} s, "
          f"{100 * plan / wall:.1f} % of the wall), host-complete "
          f"{host_wall:.4f} s ({threads} threads); stages {timers}")
    return launches, rec


def _engine_filter_records(host) -> None:
    """The engine's filter call (``codecs/mlp/engine.py::filter_lanes``:
    its eight lane arrays uploaded from the host, then
    ``mlp_filter_blocks`` from zero states) on its own host arrays, under
    the profiler: its card records must be the eight host-to-device
    copies and one K1, nothing else."""
    import numpy as np

    np.savez(ENGINE_FILTER, **{f"a{k}": a for k, a in enumerate(host)})
    kinds = _records_only("engine", {"memcpy HtoD": len(host),
                                     "mlp_filter_kernel": 1},
                          "the engine's filter call")
    print(f"[engine] its filter call on its own inputs under the profiler: "
          f"records {kinds}, no other record")


def phase_bail(layout):
    """A track the native parser bails on, through the reader API on the
    card: the warning, the spec path, the spec decoder's bytes."""
    import logging

    from dvda_tpu_torch.codecs.mlp.spec import MlpDecoder
    from dvda_tpu_torch.codecs.mlp.track import assemble_track_stream
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.utils.log import logger
    from dvda_tpu_torch.utils.wav import pack_samples_le

    class Records(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    records = Records()
    logger.addHandler(records)
    try:
        reader = _open_track(layout, DecodeConfig(device=DEV))
        t = time.perf_counter()
        got = reader.read_all_packed()
        wall = time.perf_counter() - t
    finally:
        logger.removeHandler(records)
    bails = [m for m in records.messages if "native MLP parse bailed" in m]
    _require(len(bails) == 1, f"bail warnings: {records.messages}")
    _require(reader.decode_info.get("path") == "spec",
             f"the bail disc took the {reader.decode_info} path")
    stream, _, _ = assemble_track_stream(reader.aob, reader.track.span)
    spec = MlpDecoder(reader.parameters)
    spec.decode_bytes(stream)
    want = pack_samples_le(spec.take_frames(), 24)
    _require(len(want) > 0.9 * BAIL_FRAMES * L0 * 18 and got == want,
             f"bail disc: {len(got)} port bytes differ from the spec "
             f"decoder's {len(want)}")
    print(f"[bail] {bails[0]!r}; read_all_packed took the spec path in "
          f"{wall:.2f} s; == MlpDecoder on the assembled stream: "
          f"{len(want)} bytes identical")


def _capture_call(what: str):
    """(a call, its inputs kept alive) for a ``--records`` child: one
    ``decode_step`` at ``STEP``, one chunk program on the ``UNFUSED``
    chunk, or the engine's filter call on the inputs the engine phase
    saved (``ENGINE_FILTER``), through the engine's own
    ``filter_lanes``."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    if what == "step":
        from dvda_tpu_torch.parallel.step import decode_step, example_batch

        b = example_batch(device=dev, **STEP)
        return lambda: decode_step(b)
    if what == "unfused":
        from dvda_tpu_torch.codecs.mlp import native_engine as ne
        from dvda_tpu_torch.testutil import unfused_chunk_inputs

        arenas, spec = unfused_chunk_inputs(**UNFUSED)
        a = ne.arenas_to_device(*arenas, spec, dev)
        return lambda: ne.uniform_arena_pipeline(*a, spec)
    from dvda_tpu_torch.codecs.mlp.engine import filter_lanes

    with np.load(ENGINE_FILTER) as z:
        host = [z[f"a{k}"] for k in range(len(z.files))]
    return lambda: filter_lanes(host, dev)


def _records_child(what: str) -> int:
    """``chip_smoke.py --records WHAT``: two calls of
    :func:`_capture_call`'s call, one under ``torch.profiler`` whose
    records are not read (a process's first capture has missed its first
    launch), then one more, taken again at most twice while it records
    fewer kernels than it launched; prints the last capture's card
    record names and launch counts as one JSON line."""
    import torch

    from dvda_tpu_torch.utils.profiling import _profile_call, kernel_launches

    call = _capture_call(what)
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    _profile_call(call)
    for _ in range(3):
        before = kernel_launches()
        _, records = _profile_call(call)
        after = kernel_launches()
        names = [r[0] for r in records]
        launches = {k: n - before[k] for k, n in after.items()
                    if n > before[k]}
        if sum(any(k in n for k in after) for n in names) >= sum(
                launches.values()):
            break
    print(json.dumps({"names": names, "launches": launches}))
    return 0


def _records_only(what: str, want: dict, label: str) -> dict:
    """One call of ``what`` (:func:`_capture_call`) under the profiler,
    in a child process of its own: its card records, counted by kind
    (a port kernel's name, ``memcpy HtoD``, or the record's own name),
    must be ``want``, and its launch counts ``want``'s kernels.  A child
    of its own because this card's profiler loses the records of short
    captures once a process has gone 30 s without one (PERF.md §7).
    Where a child's captures all lost records of the port's kernels and
    held no record outside ``want``, a new child takes them again, at
    most twice: the profiler loses records, it does not make them up."""
    from dvda_tpu_torch.utils.profiling import kernel_counters

    kernels = {k: n for k, n in want.items() if k in kernel_counters()}
    for child in range(3):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--records", what], cwd=ROOT,
                              capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        _require(proc.returncode == 0 and lines,
                 f"{label}: the records child exited {proc.returncode}: "
                 f"{proc.stderr[-800:]}")
        got = json.loads(lines[-1])
        kinds: dict = {}
        for name in got["names"]:
            ours = [k for k in kernel_counters() if k in name]
            kind = (ours[0] if ours else "memcpy HtoD"
                    if name.startswith("Memcpy HtoD") else name)
            kinds[kind] = kinds.get(kind, 0) + 1
        lost = (got["launches"] == kernels and set(kinds) <= set(want)
                and sum(kinds.get(k, 0) for k in kernels)
                < sum(kernels.values()))
        if not lost:
            break
        print(f"[records] {label}, child {child + 1}: the profiler kept "
              f"{kinds} of launches {got['launches']}; taken again",
              flush=True)
    _require(kinds == want and got["launches"] == kernels,
             f"{label} recorded {kinds} (launches {got['launches']}), "
             f"expected {want}")
    return kinds


def _zero_launches() -> None:
    """Every kernel wrapper's launch counter to 0, and the count of chunks
    the narrow readback ran again."""
    from dvda_tpu_torch.codecs.mlp.native_engine import decode_native
    from dvda_tpu_torch.utils.profiling import kernel_counters

    for pairs in kernel_counters().values():
        for fn, attr in pairs:
            setattr(fn, attr, 0)
    decode_native.mlp_chunks_redone = 0


def _launched(*names: str) -> dict:
    """The launch counts since :func:`_zero_launches`; fails unless each
    of ``names`` (profiler names, e.g. ``mlp_filter_kernel``) ran."""
    from dvda_tpu_torch.utils.profiling import kernel_launches

    got = {k: n for k, n in kernel_launches().items() if n}
    _require(all(got.get(k) for k in names),
             f"expected launches of {names}, counted {got}")
    return got


def phase_surface(layout, plain, enc_path: str, smi: str):
    """The C-style API, the sector sources and the two table-of-contents
    and codebook CLIs, on the card: the headline disc through
    ``dvda_open`` ... ``dvda_read`` in reads of 4,096 frames, equal to
    ``read_all()``; the encrypted disc through a callback source with the
    port's CPPM hook, equal to the host path on the plaintext copy;
    ``dvda_debug_info``'s rows against the ``Track`` objects; ``dvda-huffman
    --format json`` on codebook 2 against ``peek_lut(2)``.  The launch
    counters are zeroed before each decoding part."""
    import contextlib
    import io

    import numpy as np

    import dvda_tpu_torch as dt
    from dvda_tpu_torch.api import TrackReader
    from dvda_tpu_torch.cli import dvda_debug_info, huffman_compile
    from dvda_tpu_torch.codecs.mlp.codebooks import CODEBOOKS, peek_lut
    from dvda_tpu_torch.config import DecodeConfig
    from dvda_tpu_torch.container.aob import AOBReader
    from dvda_tpu_torch.container.sources import (CallableSectorSource,
                                                  SourceAOBReader)
    from dvda_tpu_torch.cppm.decrypt import CppmDecryptor
    from dvda_tpu_torch.ops.rematrix import output_stage
    from dvda_tpu_torch.testutil import host_track_bytes

    conf = DecodeConfig(device="cuda")
    _require(dt.default_config().device == "cuda",
             "the C-style API's decode device is not the card")
    # the C-style API: dvda_open ... dvda_read on the default device
    _zero_launches()
    t = time.perf_counter()
    disc = dt.dvda_open(layout.path)
    title = dt.dvda_open_title(dt.dvda_open_titleset(disc, 1), 1)
    track = dt.dvda_open_track(title, 1)
    reader = dt.dvda_open_track_reader(track)
    _require(reader is not None and dt.dvda_codec(reader) == dt.DVDA_MLP
             and (dt.dvda_bits_per_sample(reader), dt.dvda_sample_rate(reader),
                  dt.dvda_channel_count(reader)) == (24, 96000, 6),
             "dvda_open_track_reader: not the headline's MLP 5.1/96k/24")
    blocks = []
    while True:
        block = dt.dvda_read(reader, 4096)
        if block.shape[0] == 0:
            break
        blocks.append(block)
    wall = time.perf_counter() - t
    launches = _launched("mlp_filter_arena_kernel", "output_stage_kernel")
    _require(output_stage.narrow_launches > 0,
             "dvda_read: the 24-bit track did not read back narrow (K234n)")
    dt.dvda_close_track_reader(reader)
    got = np.concatenate(blocks)
    want = _open_track(layout, conf).read_all()
    _require(got.shape == (SECONDS * 96000, 6) and np.array_equal(got, want),
             f"dvda_read: {got.shape} frames differ from read_all()")
    _require(len(blocks) == -(-got.shape[0] // 4096),
             f"dvda_read: {len(blocks)} reads of 4,096 frames")
    print(f"[surface] dvda_open ... dvda_read: {len(blocks)} reads of 4,096 "
          f"frames == read_all() ({got.shape[0]} x 6 int32) in {wall:.3f} s; "
          f"launches {launches}")

    # the encrypted disc through a callback source and the port's hook
    aob = os.path.join(enc_path, "ATS_01_1.AOB")
    calls = []
    with open(aob, "rb") as f:
        def read(first, count):
            calls.append(count)
            f.seek(first * 2048)
            return f.read(count * 2048)

        total = os.path.getsize(aob) // 2048
        hook = CppmDecryptor(MEDIA_KEY, ALBUM, config=conf).decrypt_sectors
        etitle = dt.open_disc(enc_path).open_titleset(1).open_title(1)
        _zero_launches()
        t = time.perf_counter()
        got = [TrackReader(SourceAOBReader([CallableSectorSource(total, read)],
                                           decrypt=hook),
                           etitle.open_track(n), config=conf).read_all_packed()
               for n in (1, 2, 3)]
        wall = time.perf_counter() - t
        launches = _launched("c2_decrypt_kernel", "pcm_unpack_kernel",
                             "mlp_filter_arena_kernel",
                             "output_stage_kernel")
        _require(output_stage.narrow_launches > 0,
                 "SourceAOBReader: the MLP track did not read back narrow")
    ptitle = dt.open_disc(plain.path).open_titleset(1).open_title(1)
    threads = conf.resolved_parse_threads()
    for n, g in enumerate(got, 1):
        w = host_track_bytes(AOBReader(plain.path, 1), ptitle.open_track(n),
                             threads)
        _require(len(w) > 0 and g == w, f"SourceAOBReader track {n}: "
                                        "bytes differ from the host path")
    print(f"[surface] encrypted disc via CallableSectorSource + "
          f"SourceAOBReader(decrypt=CppmDecryptor): 3 tracks == the host "
          f"path on the plaintext copy ({sum(map(len, got))} bytes) in "
          f"{wall:.3f} s, {len(calls)} callback reads; launches {launches}")

    # dvda-debug-info: one row per track, its sectors the Track objects'
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = dvda_debug_info.main(["-A", plain.path])
    rows = [line.split() for line in out.getvalue().splitlines()[1:]
            if line.strip()]
    tracks = [ptitle.open_track(n) for n in (1, 2, 3)]
    _require(rc == 0 and [(int(r[0]), int(r[1]), int(r[4]), int(r[5]))
                          for r in rows] ==
             [(1, t.number, t.first_sector, t.last_sector) for t in tracks],
             f"dvda_debug_info: rc {rc}, rows {rows}")
    print(f"[surface] dvda_debug_info: {len(rows)} rows == the Track "
          "objects' sectors")

    # dvda-huffman --format json on codebook 2
    work = os.path.dirname(os.path.dirname(plain.path))
    src, dst = (os.path.join(work, n) for n in ("cb2.json", "cb2_lut.json"))
    flat = []
    for code, value in CODEBOOKS[2]:
        flat += [[int(b) for b in code], -1 if value is None else value]
    with open(src, "w") as f:
        json.dump(flat, f)
    rc = huffman_compile.main(["-i", src, "--format", "json", "-o", dst])
    with open(dst) as f:
        lut = json.load(f)
    vals, lens = peek_lut(2)
    _require(rc == 0 and lut["bits"] == 9
             and np.array_equal(np.asarray(lut["values"]), vals)
             and np.array_equal(np.asarray(lut["lengths"]), lens),
             "dvda-huffman --format json on codebook 2 != peek_lut(2)")
    print("[surface] dvda-huffman --format json, codebook 2 == peek_lut(2) "
          f"({len(vals)} entries); {smi}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--records"] and len(sys.argv) == 3:
        return _records_child(sys.argv[2])

    name, smi = phase_device()
    phase_build()
    work = WORK
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        layout, stream, cfg, spec = phase_synth(work)
        stereo = phase_synth_stereo(work)
        plain, enc_path, n_sectors = phase_synth_cppm(work, spec)
        kernels = phase_kernels(stream, plain, enc_path)
        launches = phase_main(layout, cfg, smi)
        phase_profile(layout, stream, smi)
        phase_unfused(smi)
        phase_modes(layout, smi)
        phase_stereo(stereo, smi)
        launches.update(phase_cppm(plain, enc_path, n_sectors, smi))
        phase_tiers(smi)
        general_layout, general_frames = phase_synth_general(work)
        k6, k6_launches = phase_general(general_layout, general_frames, smi)
        kernels.update(k6)
        launches.update(k6_launches)
        phase_step(smi)
        engine_launches, _ = phase_engine(
            phase_synth_engine(work, ENGINE_FRAMES, "engine"), smi)
        launches["frame_remix"] = engine_launches["frame_remix"]
        # the filters' launches: every MLP path's run
        launches["mlp_filter"] = sum(K1_PATHS.values())
        launches["mlp_filter_arena"] = sum(K1A_PATHS.values())
        print(f"[launches] K1 per path {K1_PATHS}: "
              f"{launches['mlp_filter']} in all; K1a per path {K1A_PATHS}: "
              f"{launches['mlp_filter_arena']} in all")
        phase_bail(phase_synth_engine(work, BAIL_FRAMES, "bail",
                                      checkdata=False))
        phase_surface(layout, plain, enc_path, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "dvda_tpu"))
    _require(not loaded, f"jax or dvda_tpu was imported: {loaded[:5]}")
    replaces = {
        "mlp_filter_arena": "dvda_tpu/ops/pallas_filter.py:37",
        "chunk_lanes": "dvda_tpu/codecs/mlp/native_engine.py:111",
        "mlp_filter": "dvda_tpu/ops/pallas_filter.py:37",
        "output_stage": "dvda_tpu/codecs/mlp/native_engine.py:282",
        "output_stage_narrow": "dvda_tpu/codecs/mlp/native_engine.py:330",
        "huffman_decode": "dvda_tpu/ops/huffman_decode.py:82",
        "pcm_unpack": "dvda_tpu/ops/pcm_unpack.py:30",
        "c2_decrypt": "dvda_tpu/ops/c2_decrypt.py:82",
        "lane_pack": "dvda_tpu/codecs/mlp/native_engine.py:502",
        "series_remix": "dvda_tpu/codecs/mlp/native_engine.py:538",
        "frame_remix": "dvda_tpu/ops/rematrix.py:33",
    }
    sources = {"lane_pack": "general_gather", "series_remix": "general_gather",
               "output_stage_narrow": "output_stage",
               "mlp_filter_arena": "chunk_filter"}
    record = {"kernels": [
        {"name": k, "route": "cuda",
         "source": f"dvda_tpu_torch/csrc/{sources.get(k, k)}.cu",
         "replaces": replaces[k], "launches": launches[k], **kernels[k]}
        for k in KERNELS]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched MLP decode engine: host planner + the port's device kernels.

Port of dvda_tpu/codecs/mlp/engine.py.  This inverts the reference's
sample-at-a-time pull decode (SURVEY §7): the host walks the bitstream
once — framing, parameter state machine, Huffman residual decode (all
inherited from the parity-proven sequential spec, spec.py) — and
*records* per-block/per-frame tensors instead of filtering.  The hot
loops (filter_channel mlp.c:1243-1306, rematrix_channels :1308-1358,
output shifts/mapping :514-533) then run as the port's kernels over the
whole stream at once, on the decoder's torch device: K1
(ops/mlp_filter.py) on every (chain, channel) lane, K9
(ops/rematrix.py::frame_remix) on every frame.

Parallelisation model:

* **Restart chains.**  Restart headers reset the IIR state and noise seed,
  but the reference carries FIR state across them (spec.py docstring), so
  a segment is independent iff no channel's first post-restart block uses
  FIR taps.  The planner splits the stream into *segments* at restart
  blocks and merges FIR-coupled neighbours into *chains*; chains × channels
  form the filter kernel's batch lanes.
* **Frames.**  Rematrixing and output are frame-local given the
  host-precomputed LFSR noise (ops/lfsr.py) and are batched over all
  frames.

Kernel shapes are the stream's own (dvda_tpu rounds them up to powers of
two to share XLA compilations; nothing here compiles per shape).

If the stream uses constructs the batched path doesn't model (substream
channel ranges changing mid-stream, mismatched substream frame lengths, no
restart header at the start), the engine replays the raw bytes through
the sequential spec decoder — output is identical either way (tested), and
:attr:`BatchedMlpDecoder.path` says which ran.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..params import StreamParameters, WAVE_CHANNEL
from ...ops.lfsr import noise_pair
from ...ops.mlp_filter import mlp_filter_blocks
from ...ops.rematrix import frame_remix
from ...utils.profiling import global_timer
from .spec import MAX_MATRICES, MlpDecoder, MlpFrameError, SubstreamState

__all__ = ["BatchedMlpDecoder", "PlanBail", "filter_lanes"]


def filter_lanes(lanes, device: torch.device):
    """The engine's filter call: its eight lane arrays (numpy, the
    arguments of :func:`mlp_filter_blocks` from ``residuals`` to
    ``block_len``) uploaded to ``device``, then the filter from zero
    states (``None``: nothing uploaded).  Returns the filter's (out
    [B, NB, S], fir_state, iir_state)."""
    return mlp_filter_blocks(*(torch.from_numpy(x).to(device)
                               for x in lanes))


class PlanBail(Exception):
    """Stream uses a construct outside the batched fast path."""


@dataclass
class _BlockRec:
    restart: bool
    block_len: int
    min_ch: int
    max_ch: int
    # per-channel rows, index 0 ↔ min_ch
    fir: list = field(default_factory=list)       # (coeffs tuple)
    iir: list = field(default_factory=list)
    shift: list = field(default_factory=list)
    quant: list = field(default_factory=list)
    iir_reload: list = field(default_factory=list)  # None or tuple(state)
    residuals: np.ndarray | None = None             # [n_ch, block_len] int32


@dataclass
class _FrameRec:
    length: int
    mmc: int
    matrices: list = field(default_factory=list)
    # matrices entries: (out_ch, coeff_tuple(len mmc+1), noise_a, noise_b,
    #                    quant, bypassed np[int32])
    noise0: np.ndarray | None = None
    noise1: np.ndarray | None = None
    output_shift: tuple = ()
    assignment: int = 0


class _Planner(MlpDecoder):
    """Parses like the spec decoder but records tensors instead of
    filtering; parameter-state semantics are inherited unchanged."""

    def __init__(self, parameters: StreamParameters):
        super().__init__(parameters)
        self.blocks: list[list[_BlockRec]] = [[], []]
        self.frames: list[_FrameRec] = []
        self._staged: list[list[_BlockRec]] = [[], []]
        self._restart_seen: list[bool] = [False, False]

    # -- capture hooks -----------------------------------------------------

    def _decode_frame(self, frame: bytes) -> int:
        self._staged = [[], []]
        return super()._decode_frame(frame)

    def _read_restart_header(self, ss: SubstreamState, r) -> None:
        super()._read_restart_header(ss, r)
        ss._restart_this_block = True  # consumed by _process_block

    def _process_block(self, ss: SubstreamState) -> None:
        s = self.substreams.index(ss)
        restart = getattr(ss, "_restart_this_block", False)
        ss._restart_this_block = False
        rec = _BlockRec(
            restart=restart,
            block_len=ss.block_size,
            min_ch=ss.min_channel,
            max_ch=ss.max_channel,
        )
        n_ch = ss.max_channel - ss.min_channel + 1
        res = np.zeros((n_ch, ss.block_size), dtype=np.int64)
        for i, c in enumerate(range(ss.min_channel, ss.max_channel + 1)):
            ch = ss.channels[c]
            # replicate the spec's validity checks so frame-drop behaviour
            # is identical (filter_channel, mlp.c:1260-1270)
            if len(ch.fir.coeff) + len(ch.iir.coeff) > 8:
                raise MlpFrameError("FIR+IIR order > 8")
            if ch.fir.shift > 0 and ch.iir.shift > 0:
                if ch.fir.shift != ch.iir.shift:
                    raise MlpFrameError("FIR/IIR shift mismatch")
                shift = ch.fir.shift
            elif ch.fir.coeff:
                shift = ch.fir.shift
            else:
                shift = ch.iir.shift
            rec.fir.append(tuple(ch.fir.coeff))
            rec.iir.append(tuple(ch.iir.coeff))
            rec.shift.append(shift)
            rec.quant.append(ss.quant_step_size[c])
            rec.iir_reload.append(
                tuple(ch.iir.state) if c in ss.iir_reloaded else None
            )
            res[i, :] = ss.residuals[c]
        rec.residuals = res.astype(np.int32)  # values are int32 by spec
        self._staged[s].append(rec)

    def _finish_frame(self, final: SubstreamState) -> None:
        length = sum(b.block_len for b in self._staged[0])
        if self.substream_count == 2:
            length1 = sum(b.block_len for b in self._staged[1])
            if length1 != length:
                raise PlanBail("substream frame length mismatch")
        fr = _FrameRec(length=length, mmc=final.max_matrix_channel,
                       assignment=self.major_sync.channel_assignment)
        for m in final.matrix_slots[: final.matrix_len]:
            byp = np.asarray(m.bypassed_lsb, dtype=np.int32)
            if byp.shape[0] < length:
                byp = np.pad(byp, (0, length - byp.shape[0]))
            fr.matrices.append((
                m.out_channel,
                tuple(m.coeff[: final.max_matrix_channel + 1]),
                m.coeff[final.max_matrix_channel + 1],
                m.coeff[final.max_matrix_channel + 2],
                final.quant_step_size[m.out_channel],
                byp[:length],
            ))
        fr.noise0, fr.noise1, new_seed = noise_pair(
            final.noise_gen_seed, length, final.noise_shift
        )
        final.noise_gen_seed = new_seed
        fr.output_shift = tuple(
            s & 31 for s in final.output_shift[: final.max_matrix_channel + 1]
        )
        for s in range(self.substream_count):
            self.blocks[s].extend(self._staged[s])
        self._staged = [[], []]
        self.frames.append(fr)


class BatchedMlpDecoder:
    """Drop-in decoder: feed packet payloads, then take all frames.

    ``decode_bytes`` returns the number of PCM frames completed (the track
    layer's termination logic depends on it); the device pipeline runs once
    in :meth:`take_frames`, on ``device`` (K1 and K9 on a CUDA device,
    their plain versions on the CPU).
    """

    def __init__(self, parameters: StreamParameters, device="cuda"):
        self.parameters = parameters
        self.device = torch.device(device)
        self._planner = _Planner(parameters)
        self._feeds: list[bytes] = []
        self._taken = 0
        self._reported = 0
        self._spec: MlpDecoder | None = None  # set after a PlanBail

    @property
    def path(self) -> str:
        """``"engine"`` (planner + kernels) or ``"spec"`` (the sequential
        spec decoder, after a construct the batched path does not
        model)."""
        return "engine" if self._spec is None else "spec"

    def decode_bytes(self, data: bytes) -> int:
        self._feeds.append(bytes(data))
        if self._spec is not None:
            with global_timer.stage("mlp/spec"):
                n = self._spec.decode_bytes(data)
            self._reported += n
            return n
        try:
            with global_timer.stage("mlp/plan"):
                n = self._planner.decode_bytes(data)
            self._reported += n
            return n
        except PlanBail:
            return self._bail_to_spec()

    def _bail_to_spec(self) -> int:
        """Replay every fed byte through the sequential spec decoder and
        continue there; returns the frame count the current feed added."""
        self._spec = MlpDecoder(self.parameters)
        total = 0
        with global_timer.stage("mlp/spec"):
            for feed in self._feeds:
                total += self._spec.decode_bytes(feed)
        added = total - self._reported
        self._reported = total
        if self._taken:
            # frames already handed out by the fast path must not reappear
            self._spec.take_frames(self._taken)
        return added

    def take_frames(self, n: int | None = None) -> np.ndarray:
        if self._spec is None:
            try:
                out = self._execute()
            except PlanBail:
                self._bail_to_spec()
        if self._spec is not None:
            out = self._spec.take_frames(n)
            self._taken += out.shape[0]
            return out
        avail = out.shape[0] - self._taken
        take = avail if n is None else min(n, avail)
        res = out[self._taken : self._taken + take]
        self._taken += take
        return res

    # -- assembly + device execution ---------------------------------------

    def _execute(self) -> np.ndarray:
        if getattr(self, "_cache", None) is not None:
            return self._cache
        p = self._planner
        frames = p.frames
        out_ch = self.parameters.channel_count
        if not frames:
            self._cache = np.zeros((0, out_ch), dtype=np.int32)
            return self._cache
        n_sub = p.substream_count

        # ---- validate the fast-path assumptions --------------------------
        spans = []
        for s in range(n_sub):
            blist = p.blocks[s]
            if not blist or not blist[0].restart:
                raise PlanBail("stream does not begin with a restart header")
            mins = {b.min_ch for b in blist}
            maxs = {b.max_ch for b in blist}
            if len(mins) != 1 or len(maxs) != 1:
                raise PlanBail("substream channel range changes mid-stream")
            spans.append((mins.pop(), maxs.pop()))
        if n_sub == 2 and spans[0][1] >= spans[1][0]:
            raise PlanBail("substream channel ranges overlap")
        mmc = frames[0].mmc
        assignment = frames[0].assignment
        if any(f.mmc != mmc or f.assignment != assignment for f in frames):
            raise PlanBail("max_matrix_channel / assignment changes")

        with global_timer.stage("mlp/engine-filter"):
            filtered = self._run_filter(spans, self.device)  # [C_all, T]
        with global_timer.stage("mlp/engine-frames"):
            out = self._run_frames(filtered, mmc, out_ch, self.device)
        self._cache = out
        return out

    def _run_filter(self, spans, device: torch.device) -> np.ndarray:
        """Assemble chains and run the batched filter (K1 on ``device``);
        returns per-channel time series [C_all, T] (channels beyond any
        substream's span are zero, matching the spec's zero default for
        unused channels)."""
        p = self._planner
        n_sub = p.substream_count
        lane_meta = []   # (s, chain_blocks: list[int] global block indices, c)
        chain_lists = []  # per substream: list of chains (lists of block idx)
        for s in range(n_sub):
            blist = p.blocks[s]
            chains: list[list[int]] = []
            coupled_prev = False
            for i, b in enumerate(blist):
                if b.restart and i > 0:
                    # segment boundary: does any channel's first block here
                    # use FIR taps?  then FIR state couples to the previous
                    # segment (reference semantics, spec.py docstring)
                    coupled = any(len(f) > 0 for f in b.fir)
                    if coupled:
                        chains[-1].append(i)
                        coupled_prev = True
                        continue
                    chains.append([i])
                elif i == 0:
                    chains.append([i])
                else:
                    chains[-1].append(i)
            chain_lists.append(chains)
            del coupled_prev

        S = max(b.block_len for s in range(n_sub) for b in p.blocks[s])
        NB = max(len(ch) for chains in chain_lists for ch in chains)
        B = sum(len(chains) * (spans[s][1] - spans[s][0] + 1)
                for s, chains in enumerate(chain_lists))

        residuals = np.zeros((B, NB, S), dtype=np.int32)
        rc_fir = np.zeros((B, NB, 8), dtype=np.int32)
        rc_iir = np.zeros((B, NB, 8), dtype=np.int32)
        shift = np.zeros((B, NB), dtype=np.int32)
        quant = np.zeros((B, NB), dtype=np.int32)
        iir_reset = np.zeros((B, NB), dtype=bool)
        iir_init = np.zeros((B, NB, 8), dtype=np.int32)
        block_len = np.zeros((B, NB), dtype=np.int32)

        lane = 0
        for s, chains in enumerate(chain_lists):
            lo, hi = spans[s]
            for chain in chains:
                for ci, c in enumerate(range(lo, hi + 1)):
                    for k, bi in enumerate(chain):
                        b = p.blocks[s][bi]
                        fir = b.fir[ci]
                        iir = b.iir[ci]
                        # reversed taps: vector index 7 = most recent
                        rc_fir[lane, k, 8 - len(fir):] = fir[::-1]
                        rc_iir[lane, k, 8 - len(iir):] = iir[::-1]
                        shift[lane, k] = b.shift[ci]
                        quant[lane, k] = b.quant[ci]
                        st = b.iir_reload[ci]
                        if st is not None:
                            iir_reset[lane, k] = True
                            if st:
                                iir_init[lane, k, 8 - len(st):] = st
                        block_len[lane, k] = b.block_len
                        residuals[lane, k, : b.block_len] = b.residuals[ci]
                    lane_meta.append((s, chain, c, lane))
                    lane += 1

        out, _, _ = filter_lanes((residuals, rc_fir, rc_iir, shift, quant,
                                  iir_reset, iir_init, block_len), device)
        out = out.cpu().numpy()  # [B, NB, S]

        # ---- reassemble per-channel time series --------------------------
        mmc_all = max(f.mmc for f in p.frames)
        T = sum(f.length for f in p.frames)
        series = np.zeros((mmc_all + 1, T), dtype=np.int32)
        # per substream: global block order defines the time axis
        for s, chains in enumerate(chain_lists):
            lo, hi = spans[s]
            # t offset of each global block of this substream
            starts = np.cumsum([0] + [b.block_len for b in p.blocks[s]])[:-1]
            for (ls, chain, c, lane) in lane_meta:
                if ls != s:
                    continue
                for k, bi in enumerate(chain):
                    b = p.blocks[s][bi]
                    t0 = starts[bi]
                    series[c, t0 : t0 + b.block_len] = out[lane, k, : b.block_len]
        return series

    def _run_frames(self, series: np.ndarray, mmc: int, out_ch: int,
                    device: torch.device) -> np.ndarray:
        """The frame-major rematrix and output stage (K9 on ``device``);
        returns int32 [T, out_ch]."""
        p = self._planner
        frames = p.frames
        F = len(frames)
        L = max(f.length for f in frames)
        C = 8  # dvda_tpu's fixed channel width (MLP's MAX_CHANNELS)
        T = sum(f.length for f in frames)

        starts = np.cumsum([0] + [f.length for f in frames])[:-1]
        # frame-batched channel tensor [F, L, C]; series padded to C channels
        if series.shape[0] < C:
            series = np.pad(series, ((0, C - series.shape[0]), (0, 0)))
        idx = np.minimum(starts[:, None] + np.arange(L)[None, :], max(T - 1, 0))
        channels = series[:, idx].transpose(1, 2, 0).copy()  # [F, L, C]

        noise = np.zeros((F, L, 2), dtype=np.int32)
        mat_coeff = np.zeros((F, MAX_MATRICES, C), dtype=np.int32)
        mat_noise = np.zeros((F, MAX_MATRICES, 2), dtype=np.int32)
        mat_out = np.zeros((F, MAX_MATRICES), dtype=np.int32)
        mat_active = np.zeros((F, MAX_MATRICES), dtype=bool)
        mat_quant = np.zeros((F, MAX_MATRICES), dtype=np.int32)
        bypassed = np.zeros((F, MAX_MATRICES, L), dtype=np.int32)
        out_shift = np.zeros((F, C), dtype=np.int32)
        for fi, f in enumerate(frames):
            noise[fi, : f.length, 0] = f.noise0
            noise[fi, : f.length, 1] = f.noise1
            out_shift[fi, : len(f.output_shift)] = f.output_shift
            for mi, (oc, coeff, na, nb, q, byp) in enumerate(f.matrices):
                mat_coeff[fi, mi, : len(coeff)] = coeff
                mat_noise[fi, mi] = (na, nb)
                mat_out[fi, mi] = oc
                mat_active[fi, mi] = True
                mat_quant[fi, mi] = q
                bypassed[fi, mi, : f.length] = byp

        # WAVE permutation: output slot w ← MLP channel c (mlp.c:527-533)
        mapping = WAVE_CHANNEL[frames[0].assignment]
        wave_perm = np.zeros(out_ch, dtype=np.int32)
        for c in range(out_ch):
            wave_perm[mapping[c]] = c

        res = frame_remix(*(
            torch.from_numpy(x).to(device) for x in (
                channels, noise, mat_coeff, mat_noise, mat_out, mat_active,
                mat_quant, bypassed, out_shift)), torch.from_numpy(wave_perm),
            n_mats=max(len(f.matrices) for f in frames))
        res = res.cpu().numpy()  # [F, L, out_ch]

        out = np.empty((T, out_ch), dtype=np.int32)
        for fi, f in enumerate(frames):
            out[starts[fi] : starts[fi] + f.length] = res[fi, : f.length]
        return out

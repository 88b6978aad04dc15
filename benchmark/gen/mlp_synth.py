"""MLP stream synthesiser — the encoder-for-tests.

The benchmark's frozen copy of ``dvda_tpu_torch/testutil/mlp_synth.py``
(imports rewritten; ``synth_two_section_stream`` left out), so that the
discs the benchmark makes do not move with the program's test helpers.

The reference ships no test vectors, so MLP decode correctness is validated
by synthesising *valid* random MLP streams, placing them on synthetic discs,
and comparing our decoder's output byte-for-byte against the reference
``dvda2wav`` (SURVEY §4's strategy).

This is not a real encoder (it doesn't compress given audio): it emits
random-but-valid frame structure, parameters and residual codes, tracking
the same sticky parameter state machine the decoder runs so the bitstream
stays parseable.  Value magnitudes are bounded so the AR reconstruction
filters stay stable and outputs fit the track's WAV sample width.

Stream layout facts mirrored from src/mlp.c (see codecs/mlp/spec.py for the
full semantics map): frame headers (:384-405), major sync (:614-654),
substream info (:656-668), checkdata (:670-712, :1360-1399), restart
headers (:809-854), decoding parameters (:856-1120), residual coding
(:1122-1241).

One reference quirk is deliberately avoided unless explicitly requested:
the reference reads *uninitialised* filter-state memory if a channel's
first ≤8 samples after stream start use FIR order > history length
(mlp.c:1285-1287), so generated streams keep FIR order 0 for a channel
until ≥8 of its samples exist.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..fmt.bitstream import BitWriter, crc8_parity
from ..fmt.codebooks import codebook_value_range, encode_map
from ..fmt.params import BPS_CODE, RATE_CODE, unpack_channel_count

__all__ = ["MlpSynthConfig", "synth_mlp_stream"]

END_MARKER = 0xD234D234


@dataclass
class MlpSynthConfig:
    channel_assignment: int = 1
    sample_rate: int = 48000
    bits_per_sample: int = 24
    substream_count: int = 1
    n_frames: int = 64
    blocks_per_frame: int = 2
    block_size: int = 16
    major_sync_every: int = 8    # frames between major syncs (1 = every frame)
    restart_every: int = 8       # frames between restart headers
    checkdata: bool = True
    seed: int = 0
    end_marker: bool = True
    # exercise the reference's cross-restart FIR state carry-over
    fir_across_restart: bool = True
    # probability of re-sending decoding parameters outside restart blocks
    # (real encoders mostly set parameters at restarts; 0.3 stresses the
    # sticky state machine)
    params_update_prob: float = 0.3
    # codebooks drawn per channel at parameter updates; narrow to (0,) to
    # pin the parser's fixed-rate (no Huffman codes) block fast path
    codebook_choices: tuple = (0, 1, 2, 3)
    # half-open range output shifts are drawn from (mlp.c applies them as
    # left shifts at the output stage).  The default keeps samples inside
    # a 16-bit WAV range; raise it (e.g. (6, 8)) to synthesise LOUD
    # streams whose 24-bit samples overflow int16 — pins the narrow-d2h
    # wide-buffer fallback (native_engine._finish_uniform)
    out_shift_range: tuple = (0, 2)

    @property
    def channels(self) -> int:
        return unpack_channel_count(self.channel_assignment)

    @property
    def frames_per_mlp_frame(self) -> int:
        return self.blocks_per_frame * self.block_size

    @property
    def total_pcm_frames(self) -> int:
        return self.n_frames * self.frames_per_mlp_frame


class _GenSubstream:
    """Mirror of the decoder's sticky per-substream parameter state."""

    def __init__(self, min_ch: int, max_ch: int, max_matrix_ch: int,
                 rng: random.Random, cfg: MlpSynthConfig):
        self.min_ch = min_ch
        self.max_ch = max_ch
        self.mmc = max_matrix_ch
        self.rng = rng
        self.cfg = cfg
        self.flags = [1] * 8
        self.block_size = cfg.block_size
        self.samples_seen = 0  # history length proxy (all channels advance together)
        self.since_restart = 0
        # per-channel sticky coding state (mirrors decoder)
        self.codebook = {}
        self.lsbs = {}
        self.quant = {c: 0 for c in range(max_ch + 1)}
        self.matrix_bypass: list[int] = []
        # one filter shift per channel for the stream's lifetime: the decoder
        # rejects FIR/IIR shift mismatches (mlp.c:1262-1265), and since FIR
        # params may persist while IIR is re-sent (or vice versa), the only
        # safe generation policy is a constant shift per channel.
        self.chan_shift = {c: rng.randrange(8, 13) for c in range(max_ch + 1)}

    # ----------------------------------------------------------- components

    def emit_restart_header(self, w: BitWriter) -> None:
        rng = self.rng
        w.write(13, 0x18F5)
        w.write(1, 0)                      # noise_type
        w.write(16, rng.randrange(1 << 16))  # output timestamp
        w.write(4, self.min_ch)
        w.write(4, self.max_ch)
        w.write(4, self.mmc)
        w.write(4, rng.randrange(4))       # noise shift
        w.write(23, rng.randrange(1, 1 << 23))  # noise gen seed
        w.write(19, 0)
        w.write(1, 0)                      # check data present
        w.write(8, 0)                      # lossless check
        w.write(16, 0)
        for c in range(self.mmc + 1):
            w.write(6, c)                  # channel assignment (≤ mmc)
        w.write(8, rng.randrange(256))     # checksum (not validated)

    def emit_matrices(self, w: BitWriter) -> None:
        rng = self.rng
        count = rng.randrange(0, min(self.mmc + 2, 6))
        w.write(4, count)
        self.matrix_bypass = []
        for _ in range(count):
            w.write(4, rng.randrange(self.mmc + 1))  # out_channel
            frac = 14
            w.write(4, frac)
            bypass = rng.randrange(2)
            w.write(1, bypass)
            self.matrix_bypass.append(bypass)
            for _c in range(self.mmc + 3):
                if rng.random() < 0.7:
                    w.write(1, 1)
                    # magnitude bounded so rematrixed outputs stay inside a
                    # 16-bit WAV sample range (see module docstring)
                    w.write_signed(frac + 2, rng.randrange(-(1 << 10), 1 << 10))
                else:
                    w.write(1, 0)

    def emit_filter(self, w: BitWriter, is_iir: bool, max_order: int,
                    shift: int) -> int:
        """Emit FIR/IIR parameters; returns the order used."""
        rng = self.rng
        order = rng.randrange(0, max_order + 1)
        w.write(4, order)
        if order == 0:
            return 0
        w.write(4, shift)
        coeff_bits = 8
        w.write(5, coeff_bits)
        w.write(3, 0)  # coeff shift
        # keep Σ|coeff| well below 2^shift for AR stability
        bound = max(1, (1 << shift) // (4 * max(order, 1)))
        bound = min(bound, (1 << (coeff_bits - 1)) - 1)
        for _ in range(order):
            w.write_signed(coeff_bits, rng.randrange(-bound, bound + 1))
        if is_iir:
            # explicit IIR state is mandatory for order > 0: reading IIR
            # parameters resets the state array (mlp.c:1098), and the
            # reference's filter indexes state with *unsigned* length
            # arithmetic — missing history becomes a ~2^32 index and a
            # guaranteed crash (mlp.c:1289-1291, array.h unsigned len)
            w.write(1, 1)
            state_bits = 6
            w.write(4, state_bits)
            w.write(4, rng.randrange(3))  # state shift
            for _ in range(order):
                w.write_signed(state_bits, rng.randrange(-31, 32))
        else:
            w.write(1, 0)  # FIR state flag must be 0
        return order

    def emit_channel_params(self, w: BitWriter, c: int) -> None:
        rng = self.rng
        shift = self.chan_shift[c]
        fir_order = 0
        can_fir = self.samples_seen >= 8 and (
            self.cfg.fir_across_restart or self.since_restart >= 8)
        if self.flags[3]:
            w.write(1, 1)  # FIR present
            if can_fir:
                fir_order = self.emit_filter(w, is_iir=False, max_order=4,
                                             shift=shift)
            else:
                # avoid the reference's uninitialised-state read: FIR order
                # 0 until ≥8 samples of history exist (see module docstring)
                w.write(4, 0)
        if self.flags[2]:
            w.write(1, 1)  # IIR present
            self.emit_filter(w, is_iir=True, max_order=2, shift=shift)
        if self.flags[1]:
            w.write(1, 1)
            w.write_signed(15, rng.randrange(-100, 101))
        cb = self.cfg.codebook_choices[
            rng.randrange(len(self.cfg.codebook_choices))]
        self.codebook[c] = cb
        q = self.quant[c]
        lsbs = rng.randrange(q + 1, q + 6)  # LSB_bits = lsbs - q in [1, 5]
        self.lsbs[c] = lsbs
        w.write(2, cb)
        w.write(5, lsbs)

    def emit_block(self, w: BitWriter, restart: bool, want_params: bool,
                   first_block: bool = True) -> None:
        rng = self.rng
        if restart:
            # with fir_across_restart=False this keeps restart segments
            # FIR-decoupled (the seekable-encoder convention): FIR taps
            # only reappear 8+ samples after each restart
            self.since_restart = 0
        if restart or want_params:
            w.write(1, 1)  # decoding parameters present
            w.write(1, 1 if restart else 0)
            if restart:
                self.emit_restart_header(w)
            # flag-update field
            if restart:
                if rng.random() < 0.5:
                    w.write(1, 1)
                    # keep flags[0]=1 so later updates stay expressible;
                    # flags[4..7] set so quant/matrix/shift/bsize stay alive
                    self.flags = [1, rng.randrange(2), rng.randrange(2),
                                  rng.randrange(2), 1, 1, 1, 1]
                    for f in self.flags:
                        w.write(1, f)
                else:
                    w.write(1, 0)
                    self.flags = [1] * 8
            elif self.flags[0]:
                w.write(1, 0)  # no flag update

            # block size
            if self.flags[7]:
                if restart or rng.random() < 0.3:
                    w.write(1, 1)
                    w.write(9, self.block_size)
                else:
                    w.write(1, 0)
            # matrices — only re-sent at a frame's first block: a slot
            # becoming active mid-frame makes the reference read stale
            # bypassed-LSB heap memory (mlp.c:1350-1353), which cannot be
            # reproduced deterministically
            if self.flags[6]:
                if restart or (first_block and rng.random() < 0.3):
                    w.write(1, 1)
                    self.emit_matrices(w)
                else:
                    w.write(1, 0)
            # output shifts (out_shift_range; default small, to keep
            # outputs in WAV sample range)
            if self.flags[5]:
                if rng.random() < 0.5:
                    w.write(1, 1)
                    for _c in range(self.mmc + 1):
                        w.write_signed(4, rng.randrange(
                            *self.cfg.out_shift_range))
                else:
                    w.write(1, 0)
            # quant step sizes (capped below each channel's sticky lsbs so
            # LSB_bits = lsbs - quant stays positive for the decoder)
            if self.flags[4]:
                if restart or rng.random() < 0.3:
                    w.write(1, 1)
                    for c in range(self.max_ch + 1):
                        cap = min(3, self.lsbs.get(c, 24))
                        q = rng.randrange(0, cap) if cap > 0 else 0
                        self.quant[c] = q
                        w.write(4, q)
                else:
                    w.write(1, 0)
            # per-channel parameters
            for c in range(self.min_ch, self.max_ch + 1):
                if restart or rng.random() < 0.4:
                    w.write(1, 1)
                    self.emit_channel_params(w, c)
                else:
                    w.write(1, 0)
        else:
            w.write(1, 0)  # no decoding parameters

        # ---- residuals -------------------------------------------------
        for _i in range(self.block_size):
            for bypass in self.matrix_bypass:
                if bypass:
                    w.write(1, rng.randrange(2))
            for c in range(self.min_ch, self.max_ch + 1):
                cb = self.codebook.get(c, 0)
                lsb_bits = self.lsbs.get(c, 24) - self.quant[c]
                if cb:
                    lo, hi = codebook_value_range(cb)
                    msb = rng.randrange(lo, hi + 1)
                    code, length = encode_map(cb)[msb]
                    w.write(length, code)
                w.write(lsb_bits, rng.randrange(1 << lsb_bits))
        self.samples_seen += self.block_size
        self.since_restart += self.block_size

    # ------------------------------------------------------------ substream

    def emit_substream(self, restart: bool, blocks: int,
                       params_prob: float | None = None) -> bytes:
        if params_prob is None:
            params_prob = self.cfg.params_update_prob
        w = BitWriter()
        rng = self.rng
        for b in range(blocks):
            self.emit_block(w, restart=restart and b == 0,
                            want_params=(b > 0 or not restart)
                            and rng.random() < params_prob,
                            first_block=b == 0)
            w.write(1, 1 if b == blocks - 1 else 0)  # last-block flag
        w.byte_align()
        if self.cfg.end_marker and rng.random() < 0.7:
            w.write(32, END_MARKER)
        data = bytearray(w.getvalue())
        if (len(data) + (2 if self.cfg.checkdata else 0)) % 2:
            data += b"\x00"  # substream_end is in 2-byte units
        if self.cfg.checkdata:
            parity, crc = crc8_parity(bytes(data))
            data += bytes([parity ^ 0xA9, crc])
        return bytes(data)


def _major_sync_bytes(cfg: MlpSynthConfig, rng: random.Random) -> bytes:
    w = BitWriter()
    w.write(24, 0xF8726F)
    w.write(8, 0xBB)
    w.write(4, BPS_CODE[cfg.bits_per_sample])
    w.write(4, 0xF)
    w.write(4, RATE_CODE[cfg.sample_rate])
    w.write(4, 0xF)
    w.write(11, 0)
    w.write(5, cfg.channel_assignment)
    w.write(48, 0)
    w.write(1, 1)                       # is_VBR
    w.write(15, rng.randrange(1 << 15))  # peak bitrate
    w.write(4, cfg.substream_count)
    w.write(92, 0)
    return w.getvalue()


def synth_mlp_stream(cfg: MlpSynthConfig) -> bytes:
    """Build a full MLP frame stream for one track."""
    rng = random.Random(cfg.seed)
    ch = cfg.channels
    if cfg.substream_count == 1:
        subs = [_GenSubstream(0, ch - 1, ch - 1, rng, cfg)]
    else:
        assert ch >= 3, "2-substream streams need ≥3 channels"
        subs = [
            _GenSubstream(0, 1, 1, rng, cfg),
            _GenSubstream(2, ch - 1, ch - 1, rng, cfg),
        ]

    out = bytearray()
    for f in range(cfg.n_frames):
        has_sync = f % cfg.major_sync_every == 0
        restart = f % cfg.restart_every == 0
        body = bytearray()
        if has_sync:
            body += _major_sync_bytes(cfg, rng)
        ss_datas = [
            s.emit_substream(restart=restart, blocks=cfg.blocks_per_frame)
            for s in subs
        ]
        # substream info words (sizes must be known first)
        info = BitWriter()
        end = 0
        for d in ss_datas:
            end += len(d)
            info.write(1, 0)                    # extraword
            info.write(1, 0 if restart else 1)  # nonrestart substream
            info.write(1, 1 if cfg.checkdata else 0)
            info.write(1, 0)
            info.write(12, end // 2)
        body += info.getvalue()
        for d in ss_datas:
            body += d
        total = 4 + len(body)
        assert total % 2 == 0 and total // 2 < (1 << 12), f"frame too big: {total}"
        hdr = BitWriter()
        hdr.write(4, 0)
        hdr.write(12, total // 2)
        hdr.write(16, rng.randrange(1 << 16))
        out += hdr.getvalue() + body
    return bytes(out)

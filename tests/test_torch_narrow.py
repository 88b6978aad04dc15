"""The narrow readback of 24-bit MLP chunks (kernel K234n, the tier
protocol of the drain, the ``narrow_d2h`` knob) against dvda_tpu.

The streams are tests/test_mlp_native.py:728-765's: 5.1 in 2 substreams,
24 frames, seed 11, with output shifts that put the peak within 12 bits
(quiet), past 12 bits but within int16 (mid) and past int16 (loud).  The
JAX side runs on the CPU as its own tests run it; the port on the CPU
runs the plain versions.  Tolerance: 0 (integer decode).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from dvda_tpu import host as jax_host
from dvda_tpu.codecs.mlp import native_engine as ne
from dvda_tpu.codecs.mlp.spec import MlpDecoder
from dvda_tpu.config import DecodeConfig as JaxConfig
from dvda_tpu.utils.wav import pack_samples_le
from dvda_tpu_torch import DecodeConfig, host
from dvda_tpu_torch.codecs.mlp import native_engine as port_ne
from dvda_tpu_torch.codecs.params import StreamParameters
from dvda_tpu_torch.testutil import (BPS_CODE, RATE_CODE, MlpSynthConfig,
                                     synth_mlp_stream)

pytestmark = pytest.mark.skipif(
    not (host.available() and jax_host.available()),
    reason="native host library unavailable")

torch.set_num_threads(1)

#: kind -> (out_shift_range, the tier a decode settles at)
KINDS = {"quiet": ((0, 1), 12), "mid": ((5, 6), 16), "loud": ((7, 8), 0)}
CPU = torch.device("cpu")
_STREAMS = {}


def _stream(kind):
    """(synth config, stream, parameters, spec decoder's WAV bytes)."""
    if kind not in _STREAMS:
        cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                             n_frames=24, seed=11,
                             out_shift_range=KINDS[kind][0])
        stream = synth_mlp_stream(cfg)
        params = StreamParameters(BPS_CODE[24], 0xF,
                                  RATE_CODE[cfg.sample_rate], 0xF, 17)
        spec = MlpDecoder(params)
        spec.decode_bytes(stream)
        ref = spec.take_frames()
        peak = int(np.abs(ref).max())
        assert (peak > 32767) == (kind == "loud")
        assert (peak > 2047) == (kind != "quiet")
        _STREAMS[kind] = (cfg, stream, params,
                          bytes(pack_samples_le(ref, 24)))
    return _STREAMS[kind]


# ------------------------------------------------ (a) the chunk program


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("tier", [12, 16])
@pytest.mark.parametrize("huffman", [False, True],
                         ids=["standard", "device_huffman"])
def test_narrow_chunk_program_matches_jax(kind, tier, huffman, monkeypatch):
    """One chunk's arenas with ``__narrow__`` at ``tier``, captured from
    dvda_tpu's dispatch, through dvda_tpu's ``_uniform_arena_pipeline`` and
    the port's ``uniform_arena_pipeline``: bit-identical, flag rows
    included; the port's arena builder gives the same spec."""
    cfg, stream, _, _ = _stream(kind)
    if huffman:
        inc = jax_host.parse_mlp_stream_begin(stream, skip_values=True)
        inc.step(0)
        parse = inc.view()
    else:
        parse = jax_host.parse_mlp_stream(stream)
    assert parse.status == 0
    subs_info = []
    for s in range(parse.substream_count):
        sub = parse.sub[s]
        NB0 = int(port_ne.restart_chains(sub, sub["NB"])[1][0])
        subs_info.append((sub, 0, int(sub["len"][0]), NB0, 0))
    nc = parse.sub[0]["NB"] // subs_info[0][3]
    L0 = int(parse.frame_len[0])
    period = subs_info[0][2] * subs_info[0][3]
    mat_mm = ne._max_matrix_slots(parse.mat_active)
    program = ne._uniform_arena_pipeline
    monkeypatch.setattr(ne, "_uniform_arena_pipeline",
                        lambda a4, a2, a1, spec, words=None:
                        (a4, a2, a1, spec, words))
    shared = ne._SharedWords(stream) if huffman else None
    dev = ne._dispatch_uniform_chunk(
        parse, subs_info, 0, nc, nc + 1, period, L0, 6, pack_bits=24,
        mat_mm=mat_mm, narrow=tier, words_all=shared)
    (a4, a2, a1, spec, jwords), _redo, jtier = dev
    assert jtier == tier and ("__narrow__", 0, tier, (), "flag") in spec
    ref = np.asarray(program(a4, a2, a1, spec, jwords))

    words = port_ne._shared_words(stream, CPU) if huffman else None
    got = port_ne.uniform_arena_pipeline(
        *port_ne.arenas_to_device(a4, a2, a1, spec, CPU), spec, words)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref)
    width = 6 * 2 if tier == 16 else 6 // 2 * 3
    assert tuple(got.shape) == ((nc + 1) * period + 8, width)
    flag = int(ref[-1, -1])
    assert (ref[-8:] == flag).all()
    want = {("quiet", 12): 3, ("mid", 12): 2, ("loud", 12): 0,
            ("quiet", 16): 1, ("mid", 16): 1, ("loud", 16): 0}
    assert flag == want[kind, tier]

    (p4, p2, p1), pspec = port_ne._build_chunk_arenas(
        parse, subs_info, 0, nc, nc + 1, period, L0, 6, 24, 0, 0, mat_mm,
        huffman=huffman, narrow=tier)
    assert pspec == spec
    for mine, theirs in ((p4, a4), (p2, a2), (p1, a1)):
        assert np.array_equal(mine, theirs)
    if huffman:
        inc.close()
    else:
        parse.close()


# ------------------------------------------------------ (b) the decodes


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("huffman", [False, True],
                         ids=["standard", "device_huffman"])
def test_narrow_decode_matches_jax(kind, huffman):
    """The stream through the port's ``decode_native`` (the pipelined
    driver) and its ``_try_uniform`` with ``narrow_d2h`` on and off, and
    through dvda_tpu's ``decode_native`` with it on (standard mode, whose
    bytes its device-Huffman mode equals): the same WAV bytes,
    equal to the spec decoder's, and the port's tier settles at 12 (quiet),
    16 (mid) or 0 (loud)."""
    _, stream, params, want = _stream(kind)
    bnd = np.zeros(0, np.int64)
    base = DecodeConfig(device="cpu", device_huffman=huffman)
    if not huffman:  # dvda_tpu's bytes are the same in both its modes
        ref = ne.decode_native(stream, bnd, len(stream), params, True,
                               JaxConfig(host_complete=False,
                                         narrow_d2h=True))
        assert bytes(ref) == want
    parse = host.parse_mlp_stream(stream)
    F = port_ne._frame_cut(parse.frame_end, bnd, len(stream))
    frame_len = parse.frame_len[:F]
    for narrow in (True, False):
        cfg = replace(base, narrow_d2h=narrow)
        info = {}
        got = port_ne.decode_native(stream, bnd, len(stream), params, True,
                                    cfg, info=info)
        assert info["path"] == "pipelined"
        assert info["tier"] == (KINDS[kind][1] if narrow else 0)
        assert info["redone"] == int(narrow and kind != "quiet")
        assert bytes(got) == want
        info = {}
        got = port_ne._try_uniform(parse, F, frame_len, int(frame_len.sum()),
                                   6, 24, True, cfg, CPU, info)
        assert info["tier"] == (KINDS[kind][1] if narrow else 0)
        assert bytes(got) == want
    parse.close()


@pytest.mark.parametrize("huffman", [False, True],
                         ids=["standard", "device_huffman"])
def test_narrow_decode_later_chunks(huffman):
    """The mid stream with uncoupled restarts (3 chains) at one chain a
    chunk: the first chunk settles the tier at 16 and is run again, the
    later two go out at 16; bytes equal narrow off and the spec
    decoder's."""
    cfg = MlpSynthConfig(channel_assignment=17, substream_count=2,
                         n_frames=24, seed=11, out_shift_range=(5, 6),
                         fir_across_restart=False, params_update_prob=0.0)
    stream = synth_mlp_stream(cfg)
    params = _stream("mid")[2]
    spec = MlpDecoder(params)
    spec.decode_bytes(stream)
    ref = pack_samples_le(spec.take_frames(), 24)
    bnd = np.zeros(0, np.int64)
    outs = []
    for narrow in (True, False):
        info = {}
        outs.append(port_ne.decode_native(
            stream, bnd, len(stream), params, True,
            DecodeConfig(device="cpu", chunk_chains=1, narrow_d2h=narrow,
                         device_huffman=huffman), info=info))
        assert info["chunks"] == 3
        assert (info["tier"], info["redone"]) == ((16, 1) if narrow
                                                  else (0, 0))
    assert bytes(outs[0]) == bytes(outs[1]) == bytes(ref)


# ------------------------------------------------ (c) the tier protocol


class _Event:
    """A copy's landing, controlled by the test: ``query`` is False until
    ``synchronize`` (or the test) sets it."""

    def __init__(self, ready):
        self.ready = ready

    def query(self):
        return self.ready

    def synchronize(self):
        self.ready = True


class _Held(port_ne._Drain):
    """The drain with the events of its flag copies under test control."""

    def __init__(self, tier, ready):
        super().__init__(CPU, 2 * 3, torch.uint8, 8, tier)
        self.ready = ready
        self.events = []

    def _landed(self):
        self.events.append(_Event(self.ready))
        return self.events[-1]


def _chunk(vals, tier):
    """A chunk output of 2-channel samples ``vals`` at ``tier``, and its
    redo, which records the tiers it was asked for."""
    from dvda_tpu_torch.ops.rematrix import narrow_pack

    def out(t):
        if t:
            return narrow_pack(vals, t)
        return torch.stack([(vals >> 8 * k) & 0xFF for k in range(3)],
                           2).to(torch.uint8).reshape(vals.shape[0], 6)

    calls = []

    def redo(t=0):
        calls.append(t)
        return out(t)

    return out(tier), redo, calls


def _vals(peak, seed):
    v = torch.from_numpy(np.random.default_rng(seed).integers(
        -peak, peak, (4, 2))).to(torch.int64)
    v[0, 0] = -peak
    return v


@pytest.mark.parametrize("case", ["fits", "mid", "loud", "unready",
                                  "throttle"])
def test_narrow_tier_protocol(case):
    """The drain held to the cases of dvda_tpu's
    ``test_narrow_poll_semantics`` (tests/test_mlp_native.py:796): the
    first flag read settles the tier (kept when the chunk fits; 12 → 16,
    that chunk run again at 16, when it fits int16; else off, the chunk
    run again wide); a flag not yet landed is left by a poll that does not
    wait and read by one that does.  Beyond it, as dvda_tpu's background
    drain does: each later chunk's own flag is read and an overflowing
    chunk run again wider; :meth:`throttle` waits for the first flag once
    3 narrow chunks were pushed unsettled.  The widened rows equal the
    samples' 24-bit bytes in every case."""
    ready = case not in ("unready", "throttle")
    first_tier = 16 if case == "loud" else 12
    drain = _Held(first_tier, ready)
    peak = {"fits": 2048, "mid": 32768, "loud": 1 << 23}.get(case, 2048)
    vals = [_vals(peak, 0)]
    out, redo, calls = _chunk(vals[0], first_tier)
    drain.push(out, 4, first_tier, redo)
    if case == "fits":
        assert drain.settled and drain.tier == 12 and not calls
        vals.append(_vals(1 << 20, 1))  # a later chunk past int16
        out2, redo2, calls2 = _chunk(vals[1], 12)
        drain.push(out2, 4, 12, redo2)
        assert calls2 == [0] and drain.tier == 12 and drain.redone == 1
    elif case == "mid":
        assert calls == [16] and drain.tier == 16 and drain.redone == 1
    elif case == "loud":
        assert calls == [0] and drain.tier == 0 and drain.redone == 1
    elif case == "unready":
        drain.poll()
        assert not drain.settled and drain.tier == 12
        drain.poll(block=True)
        assert drain.settled and drain.tier == 12 and not calls
    else:
        vals.append(_vals(2048, 1))
        drain.push(_chunk(vals[-1], 12)[0], 4, 12, None)
        drain.throttle()
        assert not drain.settled  # 2 unsettled: no wait
        vals.append(_vals(2048, 2))
        drain.push(_chunk(vals[-1], 12)[0], 4, 12, None)
        drain.throttle()  # the third: waits for the first flag only
        assert drain.settled and drain.tier == 12
        assert [e.ready for e in drain.events] == [True, False, False]
    got = drain.finish(4 * len(vals))
    want = torch.cat(vals).numpy()
    wide = np.stack([(want >> 8 * k) & 0xFF for k in range(3)], 2)
    assert np.array_equal(got, wide.astype(np.uint8).reshape(-1, 6))


# ------------------------------------------------------ (d) the config


@pytest.mark.parametrize("raw,want", [("1", True), ("0", False),
                                      (None, None), ("yes", ValueError)])
def test_narrow_d2h_env(raw, want, monkeypatch):
    """``DVDA_TPU_TORCH_NARROW_D2H``: 1, 0, unset (on) or an error, as
    dvda_tpu's ``DVDA_TPU_NARROW_D2H``."""
    if raw is None:
        monkeypatch.delenv("DVDA_TPU_TORCH_NARROW_D2H", raising=False)
    else:
        monkeypatch.setenv("DVDA_TPU_TORCH_NARROW_D2H", raw)
    if want is ValueError:
        with pytest.raises(ValueError, match="NARROW_D2H"):
            DecodeConfig.from_env()
        return
    cfg = DecodeConfig.from_env()
    assert cfg.narrow_d2h is want
    assert cfg.resolved_narrow_d2h() is (want is not False)
    assert port_ne._narrow_tier0(24, 6, cfg) == (12 if want is not False
                                                 else 0)
    assert port_ne._narrow_tier0(24, 5, cfg) == (16 if want is not False
                                                 else 0)
    assert port_ne._narrow_tier0(16, 6, cfg) == 0

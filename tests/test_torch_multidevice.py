"""Chunk round-robin over several devices (``DecodeConfig.multi_device``,
``_decode_devices``) and the drain without its side stream
(``DecodeConfig(drain_thread=False)``), against the one-device decode and
dvda_tpu's ``decode_native``.

On the CPU the device list is faked: ``_decode_devices`` returns three
distinct ``torch.device("cpu")`` objects, and a spy on ``arenas_to_device``
shows which one each chunk went to.  Streams: the pipelined path, the
whole-parse ``_try_uniform``, device Huffman, and the 24-bit mid stream of
tests/test_torch_narrow.py whose first chunk misses its 12-bit tier and
is run again.  Tolerance: 0 (bytes).  dvda_tpu is imported where its
bytes are needed, so that the ``-m cuda`` test runs on a host without jax.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from dvda_tpu_torch import DecodeConfig, host
from dvda_tpu_torch.codecs.mlp import native_engine as port_ne
from dvda_tpu_torch.codecs.params import StreamParameters
from dvda_tpu_torch.testutil import (BPS_CODE, RATE_CODE, MlpSynthConfig,
                                     synth_mlp_stream)

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")

torch.set_num_threads(1)

UNIFORM = dict(fir_across_restart=False, params_update_prob=0.0)
FIVE_ONE = dict(channel_assignment=17, substream_count=2)
#: name -> (synth config, decode config fields, the path it takes)
STREAMS = {
    "pipelined": (dict(n_frames=48, sample_rate=96000, seed=2, **FIVE_ONE,
                       **UNIFORM), dict(chunk_chains=2), "pipelined"),
    "device_huffman": (dict(n_frames=48, sample_rate=96000, seed=2,
                            **FIVE_ONE, **UNIFORM),
                       dict(chunk_chains=2, device_huffman=True,
                            huffman_split=8), "pipelined"),
    # the mid stream with uncoupled restarts at one chain a chunk: the
    # first chunk overflows tier 12, settles the track at 16 and is redone
    "narrow_redo": (dict(n_frames=24, seed=11, out_shift_range=(5, 6),
                         **FIVE_ONE, **UNIFORM),
                    dict(chunk_chains=1), "pipelined"),
    "loud": (dict(n_frames=24, seed=11, out_shift_range=(7, 8), **FIVE_ONE,
                  **UNIFORM), dict(chunk_chains=1), "pipelined"),
    "param_updates": (dict(n_frames=40, restart_every=4, major_sync_every=4,
                           seed=12, fir_across_restart=False,
                           params_update_prob=0.4, **FIVE_ONE),
                      dict(chunk_chains=2), "pipelined"),
}
CPU = torch.device("cpu")
_CACHE = {}


def _synth(name):
    """(stream, parameters)."""
    if name not in _CACHE:
        cfg = MlpSynthConfig(**STREAMS[name][0])
        _CACHE[name] = (synth_mlp_stream(cfg), StreamParameters(
            BPS_CODE[cfg.bits_per_sample], 0xF, RATE_CODE[cfg.sample_rate],
            0xF, cfg.channel_assignment))
    return _CACHE[name]


def _stream(name):
    """(stream, parameters, dvda_tpu's decode_native bytes)."""
    from dvda_tpu.codecs.mlp import native_engine as ne
    from dvda_tpu.config import DecodeConfig as JaxConfig

    stream, params = _synth(name)
    ref = ne.decode_native(stream, np.zeros(0, np.int64), len(stream),
                           params, True, JaxConfig(host_complete=True))
    return stream, params, bytes(ref)


def _round_robin(monkeypatch, n=3):
    """Fake ``n`` devices; returns the list and the devices the chunks'
    arenas were sent to, in chunk order."""
    devices = [torch.device("cpu") for _ in range(n)]
    monkeypatch.setattr(port_ne, "_decode_devices", lambda cfg: devices)
    sent = []
    real = port_ne.arenas_to_device

    def spy(a4, a2, a1, spec, device):
        sent.append(device)
        return real(a4, a2, a1, spec, device)

    monkeypatch.setattr(port_ne, "arenas_to_device", spy)
    return devices, sent


def _decode(name, info=None, **kw):
    stream, params = _synth(name)
    cfg = DecodeConfig(device="cpu", **dict(STREAMS[name][1], **kw))
    return bytes(port_ne.decode_native(stream, np.zeros(0, np.int64),
                                       len(stream), params, True, cfg,
                                       info=info))


def _uniform(name, **kw):
    """The stream through ``_try_uniform`` (the whole-parse path)."""
    stream, params = _synth(name)
    parse = host.parse_mlp_stream(stream)
    bnd = np.zeros(0, np.int64)
    F = port_ne._frame_cut(parse.frame_end, bnd, len(stream))
    frame_len = parse.frame_len[:F]
    info = {}
    out = port_ne._try_uniform(
        parse, F, frame_len, int(frame_len.sum()), 6, 24, True,
        DecodeConfig(device="cpu", **dict(STREAMS[name][1], **kw)), CPU,
        info)
    parse.close()
    return bytes(out), info


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_round_robin_matches(name, monkeypatch):
    """Chunk ``i`` goes to device ``i % 3``; the bytes equal the
    one-device decode and dvda_tpu's."""
    one_info = {}
    one = _decode(name, one_info)
    devices, sent = _round_robin(monkeypatch)
    info = {}
    got = _decode(name, info)
    assert info["path"] == STREAMS[name][2] and info["chunks"] >= 3
    n_redo = info.get("redone", 0)
    assert len(sent) == info["chunks"]
    assert [id(d) for d in sent] == [id(devices[i % 3])
                                     for i in range(len(sent))]
    assert (info.get("tier"), n_redo) == (one_info.get("tier"),
                                          one_info.get("redone"))
    assert got == one == _stream(name)[2]
    if name == "narrow_redo":
        assert (info["tier"], n_redo) == (16, 1)


@pytest.mark.parametrize("name", ["pipelined", "narrow_redo"])
def test_round_robin_whole_parse(name, monkeypatch):
    """``_try_uniform`` sends chunk ``i`` to device ``i % 3`` too."""
    one, one_info = _uniform(name)
    devices, sent = _round_robin(monkeypatch)
    got, info = _uniform(name)
    assert info["chunks"] >= 3 and len(sent) == info["chunks"]
    assert [id(d) for d in sent] == [id(devices[i % 3])
                                     for i in range(len(sent))]
    assert got == one == _stream(name)[2]
    assert (info["tier"], info["redone"]) == (one_info["tier"],
                                              one_info["redone"])


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_no_drain_thread_matches(name):
    """``drain_thread=False`` gives the default mode's bytes and tier, on
    the pipelined and the whole-parse path."""
    info, off = {}, {}
    want = _decode(name, info)
    assert _decode(name, off, drain_thread=False) == want
    assert off["tier"] == info["tier"] and off["chunks"] == info["chunks"]
    got, uinfo = _uniform(name, drain_thread=False)
    assert got == want == _stream(name)[2]
    assert uinfo["tier"] == _uniform(name)[1]["tier"]


def _chunk(vals, tier):
    """A chunk of 2-channel samples at ``tier`` and its redo, which
    records the tiers it was asked for (tests/test_torch_narrow.py)."""
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


def test_no_drain_thread_protocol():
    """Without the side stream the first flag is read at its push (it
    settles the tier at 12), a later chunk's flag only at ``finish``,
    which copies every chunk in push order and runs the overflowing
    chunk's redo then; the widened rows equal the samples' bytes and the
    bytes drained equal the side-stream drain's."""
    rng = np.random.default_rng(3)
    vals = [torch.from_numpy(rng.integers(-p, p, (4, 2))).to(torch.int64)
            for p in (2048, 1 << 20, 2048)]
    drained = []
    for side in (True, False):
        drain = port_ne._Drain(CPU, 6, torch.uint8, 2, 12, side=side)
        calls = []
        for v in vals:
            out, redo, c = _chunk(v, 12)
            drain.push(out, 4, 12, redo)
            calls.append(c)
        assert drain.settled and drain.tier == 12
        assert calls[1] == ([0] if side else [])
        got = drain.finish(12)
        assert calls == [[], [0], []] and drain.redone == 1
        want = torch.cat(vals).numpy()
        wide = np.stack([(want >> 8 * k) & 0xFF for k in range(3)], 2)
        assert np.array_equal(got, wide.astype(np.uint8).reshape(-1, 6))
        drained.append(drain.drained)
    assert drained[0] == drained[1]


def test_decode_devices_rules(monkeypatch):
    """A device list only with ``multi_device`` on, a CUDA decode device
    and more than one visible card; never a fallback."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert not DecodeConfig().multi_device
    assert port_ne._decode_devices(DecodeConfig()) is None
    assert port_ne._decode_devices(
        DecodeConfig(device="cpu", multi_device=True)) is None
    assert port_ne._decode_devices(DecodeConfig(multi_device=True)) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_ne._decode_devices(DecodeConfig(multi_device=True)) is None
    # multi_device on the CPU is the one-device decode
    assert _decode("pipelined", multi_device=True) == _stream("pipelined")[2]


@pytest.mark.parametrize("env,field,raw,want", [
    ("DVDA_TPU_TORCH_MULTI_DEVICE", "multi_device", "1", True),
    ("DVDA_TPU_TORCH_MULTI_DEVICE", "multi_device", None, False),
    ("DVDA_TPU_TORCH_DISABLE_DRAIN_THREAD", "drain_thread", "1", False),
    ("DVDA_TPU_TORCH_DISABLE_DRAIN_THREAD", "drain_thread", None, True),
])
def test_env_knobs(env, field, raw, want, monkeypatch):
    if raw is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, raw)
    assert getattr(DecodeConfig.from_env(), field) is want


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pipelined", "device_huffman",
                                  "narrow_redo"])
def test_round_robin_cuda(name, monkeypatch):
    """``[cuda:0, cuda:0]``: the per-device drain bookkeeping on one card,
    with and without the side stream; each chunk through K1a; bytes
    equal host-complete."""
    from dvda_tpu_torch.ops.chunk_filter import chunk_filter

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    stream, params = _synth(name)
    devices = [torch.device("cuda", 0), torch.device("cuda", 0)]
    monkeypatch.setattr(port_ne, "_decode_devices", lambda cfg: devices)
    hc = port_ne.decode_host_complete(stream, np.zeros(0, np.int64),
                                      len(stream), params, True)
    for side in (True, False):
        before = chunk_filter.launches
        cfg = replace(DecodeConfig(**STREAMS[name][1]), drain_thread=side)
        got = port_ne.decode_native(stream, np.zeros(0, np.int64),
                                    len(stream), params, True, cfg)
        assert chunk_filter.launches > before
        assert bytes(got) == bytes(hc)

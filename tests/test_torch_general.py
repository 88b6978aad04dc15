"""The port's whole-parse decode on the CPU against dvda_tpu's: streams the
pipelined driver abandons (the general path: K6a, K1, K6b through their
plain versions) and a uniform parse (``_try_uniform``), in standard and
device-Huffman mode.  Bit-exact, and equal to the port's host-complete
reconstruction."""

import numpy as np
import pytest
import torch

from dvda_tpu import host as jax_host
from dvda_tpu.codecs.mlp import native_engine as ne
from dvda_tpu.config import DecodeConfig as JaxConfig
from dvda_tpu_torch import DecodeConfig, host
from dvda_tpu_torch.codecs.mlp import native_engine as pe
from dvda_tpu_torch.codecs.params import StreamParameters
from dvda_tpu_torch.ops.general_gather import general_pipeline_reference
from dvda_tpu_torch.testutil import (BPS_CODE, RATE_CODE, MlpSynthConfig,
                                     synth_mlp_stream)

pytestmark = pytest.mark.skipif(
    not (host.available() and jax_host.available()),
    reason="native host library unavailable")

torch.set_num_threads(1)

FIVE_ONE = dict(channel_assignment=17, substream_count=2)
BND = np.zeros(0, np.int64)
CPU = DecodeConfig(device="cpu")


def _params(cfg):
    return StreamParameters(BPS_CODE[cfg.bits_per_sample], 0xF,
                            RATE_CODE[cfg.sample_rate], 0xF,
                            cfg.channel_assignment)


def _churn():
    """The 12-section stream of tests/test_mlp_native.py:257-266: 2-frame
    sections alternating 2 × 32 and 2 × 16 samples per frame, a restart
    at every frame, 5.1/48k/24."""
    base = dict(channel_assignment=17, substream_count=2, sample_rate=48000,
                bits_per_sample=24, fir_across_restart=False,
                params_update_prob=0.0, n_frames=2, restart_every=1,
                major_sync_every=1)
    stream = b"".join(
        synth_mlp_stream(MlpSynthConfig(blocks_per_frame=2,
                                        block_size=16 if i % 2 else 32,
                                        seed=i, **base))
        for i in range(12))
    return stream, _params(MlpSynthConfig(**base))


def _two_section():
    c1 = MlpSynthConfig(blocks_per_frame=2, block_size=32, n_frames=8,
                        seed=11, **FIVE_ONE)
    c2 = MlpSynthConfig(blocks_per_frame=2, block_size=64, n_frames=8,
                        seed=12, **FIVE_ONE)
    return synth_mlp_stream(c1) + synth_mlp_stream(c2), _params(c1)


def _coupled():
    c = MlpSynthConfig(restart_every=2, major_sync_every=2, n_frames=16,
                       seed=7, **FIVE_ONE)
    return synth_mlp_stream(c), _params(c)


@pytest.fixture
def jax_pipeline_calls(monkeypatch):
    """Counts the calls of dvda_tpu's general program ``_pipeline``."""
    calls = []
    orig = ne._pipeline

    def counted(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(ne, "_pipeline", counted)
    return calls


@pytest.mark.parametrize("want_packed", [False, True])
@pytest.mark.parametrize("huffman", [False, True])
def test_churn_stream_matches_jax(jax_pipeline_calls, huffman, want_packed):
    """More than 8 geometry sections: both packages abandon the pipelined
    driver and decode the stream on their general path."""
    stream, params = _churn()
    info = {}
    got = pe.decode_native(stream, BND, len(stream), params, want_packed,
                           DecodeConfig(device="cpu", device_huffman=huffman),
                           info=info)
    ref = ne.decode_native(stream, BND, len(stream), params, want_packed,
                           JaxConfig(host_complete=False,
                                     device_huffman=huffman))
    assert jax_pipeline_calls == [1] and info["path"] == "general"
    assert got.dtype == ref.dtype == np.int32
    assert np.array_equal(got, ref)
    hc = pe.decode_host_complete(stream, BND, len(stream), params)
    assert np.array_equal(got, hc) and got.shape == (6 * 2 * (64 + 32), 6)


def _parsed(pkg_host, stream):
    inc = pkg_host.parse_mlp_stream_begin(stream)
    inc.step(0)
    return inc


@pytest.mark.parametrize("want_packed", [False, True])
def test_decode_parsed_uniform(jax_pipeline_calls, want_packed):
    """``_decode_parsed`` on a uniform parse takes ``_try_uniform`` (the
    arena chunk program over the whole stream) in both packages."""
    cfg = MlpSynthConfig(sample_rate=96000, n_frames=48, seed=3,
                         fir_across_restart=False, params_update_prob=0.0,
                         **FIVE_ONE)
    stream, params = synth_mlp_stream(cfg), _params(cfg)
    inc, jinc = _parsed(host, stream), _parsed(jax_host, stream)
    try:
        info = {}
        got = pe._decode_parsed(inc.view(), BND, len(stream), params,
                                want_packed, DecodeConfig(device="cpu",
                                                          chunk_chains=2),
                                torch.device("cpu"), info)
        ref = ne._decode_parsed(jinc.view(), BND, len(stream), params,
                                want_packed, JaxConfig(host_complete=False,
                                                       chunk_chains=2))
    finally:
        inc.close()
        jinc.close()
    # the narrow readback (on by default) settles this quiet stream at 12
    assert {k: info.pop(k) for k in ("tier", "redone")} == {"tier": 12,
                                                            "redone": 0}
    assert info.pop("drained") > 0
    assert info == {"path": "uniform", "chunks": 3}
    assert jax_pipeline_calls == []
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert got.dtype == (np.uint8 if want_packed else np.int32)


@pytest.mark.parametrize("make", [_two_section, _coupled])
def test_forced_general_matches_jax_pipeline(jax_pipeline_calls, monkeypatch,
                                             make):
    """The two-section and coupled-restart streams of
    tests/test_torch_decode.py, forced off ``_try_uniform`` in both
    packages: the port's ``general_pipeline_reference`` against dvda_tpu's
    ``_pipeline`` on the tables each builds from the same stream."""
    stream, params = make()
    monkeypatch.setattr(ne, "_try_uniform", lambda *a, **k: None)
    monkeypatch.setattr(pe, "_try_uniform", lambda *a, **k: None)
    ran = []

    def reference(subs, frames):
        ran.append(len(subs))
        return general_pipeline_reference(subs, frames)

    monkeypatch.setattr(pe, "general_pipeline", reference)
    inc, jinc = _parsed(host, stream), _parsed(jax_host, stream)
    try:
        info = {}
        got = pe._decode_parsed(inc.view(), BND, len(stream), params, False,
                                CPU, torch.device("cpu"), info)
        ref = ne._decode_parsed(jinc.view(), BND, len(stream), params, False,
                                JaxConfig(host_complete=False))
    finally:
        inc.close()
        jinc.close()
    assert ran == [2] and jax_pipeline_calls == [1]
    assert info["path"] == "general"
    assert np.array_equal(got, ref)
    hc = pe.decode_host_complete(stream, BND, len(stream), params)
    assert np.array_equal(got, hc)


class _NoBlocks:
    """A parse view in which substream ``s`` has no blocks in any frame."""

    def __init__(self, view, s):
        self._view = view
        self.sub = [dict(d) for d in view.sub]
        self.sub[s]["fr_nblocks"] = np.zeros_like(self.sub[s]["fr_nblocks"])

    def __getattr__(self, name):
        return getattr(self._view, name)


@pytest.mark.parametrize("empty", [0, 1])
def test_substream_without_blocks_matches_jax(jax_pipeline_calls, empty):
    """A substream with no blocks in the kept frames: dvda_tpu's general
    table build raises ValueError before ``_pipeline`` runs, and the
    port's raises it too, never NotImplementedError."""
    stream, params = _two_section()
    inc, jinc = _parsed(host, stream), _parsed(jax_host, stream)
    try:
        info = {}
        with pytest.raises(ValueError):
            ne._decode_parsed(_NoBlocks(jinc.view(), empty), BND,
                              len(stream), params, False,
                              JaxConfig(host_complete=False))
        with pytest.raises(ValueError, match="no blocks"):
            pe._decode_parsed(_NoBlocks(inc.view(), empty), BND,
                              len(stream), params, False, CPU,
                              torch.device("cpu"), info)
    finally:
        inc.close()
        jinc.close()
    assert jax_pipeline_calls == [] and info["path"] == "general"


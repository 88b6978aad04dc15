"""K10's plain version (the chunk program's arena front end) against the
arrays dvda_tpu's own chunk program hands its filter and K5.

Each stream of tests/test_torch_chunk.py's STREAMS is parsed and packed
into a chunk's arenas by dvda_tpu (a partial chunk, as there), in standard
mode and in device-Huffman mode.  dvda_tpu's ``_uniform_arena_pipeline``
then runs eagerly (``jax.disable_jit``) with its filter
(``ops.mlp_filter.mlp_filter_blocks_tl``) and its residual decode
(``ops.huffman_decode.decode_residuals_device``) replaced by recorders,
which the chunk program imports at call time.  The port's
``chunk_lanes_reference`` on the same arenas must give the recorded
arrays bit for bit (tolerance 0): the fused filter's ten arguments and,
in device-Huffman mode, K5's lane inputs.  Also: K10's wrapper on the CPU,
the layout's refusals, K5's output lane offset, and the chunk program on
int32 residual arenas against dvda_tpu's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dvda_tpu.ops.huffman_decode as jax_huffman
import dvda_tpu.ops.mlp_filter as jax_filter
from dvda_tpu import host
from dvda_tpu.codecs.mlp import native_engine as ne
from dvda_tpu_torch.codecs.mlp import native_engine as port_ne
from dvda_tpu_torch.ops.chunk_lanes import (chunk_lanes,
                                            chunk_lanes_reference,
                                            chunk_layout)
from dvda_tpu_torch.ops.huffman_decode import (decode_residuals_device,
                                               decode_residuals_reference)
from dvda_tpu_torch.testutil import (CHUNK_LANES_EDGES, MlpSynthConfig,
                                     chunk_lanes_inputs, huffman_inputs,
                                     synth_mlp_stream)
from test_torch_chunk import STREAMS, _chunk_inputs

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")

torch.set_num_threads(1)

#: the device-Huffman sub-lane split of each stream (0: a block a lane)
SPLITS = {"stereo": 0, "5.1": 8, "16bit": 0, "param_updates": 7}


class _Recorded(Exception):
    pass


def _jax_arenas(name, huffman, monkeypatch):
    """dvda_tpu's arenas, spec and words for a partial chunk of
    ``STREAMS[name]``."""
    cfg = MlpSynthConfig(**STREAMS[name])
    stream = synth_mlp_stream(cfg)
    parse, subs_info, period, L0 = _chunk_inputs(
        stream, SPLITS[name] if huffman else None)
    nc = subs_info[0][0]["NB"] // subs_info[0][3] - 1
    kw = dict(pack_bits=ne._pack_bits(cfg.bits_per_sample),
              mat_mm=ne._max_matrix_slots(parse.mat_active))
    if huffman:
        kw["words_all"] = ne._SharedWords(stream)
    with monkeypatch.context() as m:
        m.setattr(ne, "_uniform_arena_pipeline",
                  lambda a4, a2, a1, spec, words=None:
                  (a4, a2, a1, spec, words))
        a4, a2, a1, spec, words = ne._dispatch_uniform_chunk(
            parse, [si + (0,) for si in subs_info], 0, nc, nc + 2, period,
            L0, cfg.channels, **kw)
    return parse, (a4, a2, a1), spec, words


def _record(arenas, spec, words, monkeypatch):
    """(the filter launches' arguments, K5's calls' lane inputs) of
    dvda_tpu's chunk program on ``arenas``."""
    launches = len(chunk_layout(spec).groups)
    filters, k5 = [], []

    def filter_recorder(*args):
        filters.append([np.asarray(a) for a in args[:10]])
        if len(filters) == launches:
            raise _Recorded
        return (jnp.zeros(args[0].shape, jnp.int32),)

    def k5_recorder(words, *args, **kw):
        k5.append([np.asarray(a) for a in args[:6]])
        Lc, C = args[1].shape
        S0, NB0 = args[6], args[10]
        return (jnp.zeros((NB0, S0, C * (Lc // NB0)), jnp.int32),
                jnp.zeros((Lc, S0), jnp.int32))

    monkeypatch.setattr(jax_filter, "mlp_filter_blocks_tl", filter_recorder)
    monkeypatch.setattr(jax_huffman, "decode_residuals_device", k5_recorder)
    with jax.disable_jit(), pytest.raises(_Recorded):
        ne._uniform_arena_pipeline(*arenas, spec, words)
    return filters, k5


def _same(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    assert str(got.dtype).split(".")[1] == str(want.dtype), what
    assert tuple(got.shape) == want.shape, what
    assert np.array_equal(got.numpy(), want), what


@pytest.mark.parametrize("huffman", [False, True],
                         ids=["standard", "device_huffman"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_chunk_lanes_reference_matches_jax(name, huffman, monkeypatch):
    parse, arenas, spec, words = _jax_arenas(name, huffman, monkeypatch)
    filters, k5 = _record(arenas, spec, words, monkeypatch)
    got = chunk_lanes_reference(
        *port_ne.arenas_to_device(*arenas, spec, "cpu"), spec)
    assert len(got.filters) == len(filters) == 1  # every stream fuses
    names = ("res_tl", "rc_fir", "rc_iir", "shift", "quant", "iir_reset",
             "iir_init", "block_len", "fir_state0", "iir_state0")
    for j, (mine, theirs) in enumerate(zip(got.filters[0], filters[0],
                                           strict=True)):
        if huffman and j == 0:  # K5's output: the recorder's zeros
            assert tuple(mine.shape) == theirs.shape
            continue
        _same(mine, theirs, names[j])
    if huffman:
        assert len(k5) == len(got.huffman) == parse.substream_count
        for i, (mine, theirs) in enumerate(zip(got.huffman, k5)):
            for j, (m, t) in enumerate(zip(mine, theirs, strict=True)):
                _same(m, t, f"substream {i} K5 input {j}")
    else:
        assert k5 == [] and got.huffman == [None] * parse.substream_count
    # K10's wrapper on the CPU runs the plain version and counts nothing:
    # a device-Huffman chunk's K5 inputs; a standard chunk has none
    before = chunk_lanes.launches
    cpu = port_ne.arenas_to_device(*arenas, spec, "cpu")
    if huffman:
        again = chunk_lanes(*cpu, spec)
        assert again.filters is None and again.places == got.places
        for mine, theirs in zip(again.huffman, got.huffman, strict=True):
            for a, b in zip(mine, theirs, strict=True):
                assert torch.equal(a, b)
    else:
        with pytest.raises(ValueError, match="no K5 inputs"):
            chunk_lanes(*cpu, spec)
    assert chunk_lanes.launches == before
    parse.close()


@pytest.mark.parametrize("case", CHUNK_LANES_EDGES, ids=lambda c: c[0])
def test_chunk_layout_edge_cases(case):
    """The layout of each K10 edge case: its filter launches (fused where
    the substreams share (NB0, S0)), each substream's place, and the plain
    version's shapes."""
    (a4, a2, a1), spec = chunk_lanes_inputs(case)
    lay = chunk_layout(spec)
    name, geometry, Bc = case[:3]
    fused = len(geometry) > 1 and len({g[1:] for g in geometry}) == 1
    assert len(lay.groups) == (1 if fused else len(geometry))
    got = chunk_lanes_reference(*map(torch.from_numpy, (a4, a2, a1)), spec)
    lane = 0
    for i, (n_ch, NB0, S0) in enumerate(geometry):
        g, lane0 = got.places[i]
        assert (g, lane0) == ((0, lane) if fused else (i, 0))
        lane += n_ch * Bc
        res, fir = got.filters[g][:2]
        assert res.shape[:2] == (NB0, S0) and fir.shape[1:] == (NB0, 8)
    for args in got.filters:
        assert not args[8].any() and args[8] is args[9]
        assert args[5].dtype == torch.bool
        assert (args[7] == args[0].shape[1]).all()
    if case[4]:
        # K5's quant: the filter's quant rows, chain-major
        n_ch, NB0 = geometry[0][:2]
        q = got.huffman[0][4].view(Bc, NB0, n_ch).permute(2, 0, 1)
        assert torch.equal(q.reshape(-1, NB0), got.filters[0][4][:n_ch * Bc])


def test_chunk_layout_refuses():
    """Specs K10 cannot take raise before any kernel sees a pointer."""
    base = (("s0_res", 2, 0, (1, 1, 1, 1), "int16"),
            ("s0_rc_fir_c", 2, 1, (1, 1, 8), "int16"))
    with pytest.raises(ValueError, match="signed"):
        chunk_layout(base + (("s0_shift_c", 1, 0, (1, 1), "uint8"),))
    with pytest.raises(ValueError, match="at most 4"):
        chunk_layout(base + (("s4_res", 2, 0, (1, 1, 1, 1), "int16"),))
    with pytest.raises(ValueError, match="mix"):
        chunk_layout(base + (("s1_bitpos", 4, 0, (1, 1, 1), "int32"),))


@pytest.mark.parametrize("lane0,extra", [(0, 0), (5, 7), (12, 0)])
def test_huffman_writes_at_lane_offset(lane0, extra):
    """K5's ``out``/``lane0`` (the fused filter input): the residuals land
    in their lanes of the wider tensor, every other lane untouched; the
    other output as without ``out``."""
    case = huffman_inputs(3, 32, 2, 3, 12, 6, True)
    NB0 = 4
    args = [torch.from_numpy(case["words"].view(np.int32))] + [
        torch.from_numpy(np.asarray(case[n])) for n in (
            "bitpos", "codebook", "lsb_bits", "offset", "quant", "nbyp")
    ] + [case["S0"], case["J"], case["k"]]
    want, want_byp = decode_residuals_reference(*args, NB0=NB0)
    width = want.shape[2]
    out = torch.full((NB0, case["S0"], lane0 + width + extra), -7,
                     dtype=torch.int32)
    got, byp = decode_residuals_device(*args, NB0=NB0, out=out, lane0=lane0)
    assert got is out and torch.equal(byp, want_byp)
    assert torch.equal(out[:, :, lane0 : lane0 + width], want)
    rest = torch.cat([out[:, :, :lane0], out[:, :, lane0 + width:]], 2)
    assert (rest == -7).all()
    with pytest.raises(ValueError, match="holds no lanes"):
        decode_residuals_device(*args, NB0=NB0, out=out, lane0=extra + 1
                                + lane0)
    with pytest.raises(ValueError, match="holds no lanes"):
        decode_residuals_device(*args, NB0=0, out=out)


def _hand_arenas(rng, res_dtype, amp, per_chain):
    """Fused two-substream arenas built by hand (random values in the
    parser's ranges), residuals of ``res_dtype`` up to ``amp``."""
    Bc, L0, fpc, C = 4, 20, 2, 6
    period = L0 * fpc
    F_pad, T_pad = Bc * fpc, Bc * period
    b = port_ne._NativeArenaBuilder(None)
    for s, (n_ch, NB0, S0) in enumerate(((2, 2, 20), (4, 2, 20))):
        b.add_host(f"s{s}_res", rng.integers(
            -amp, amp, (Bc, NB0, n_ch, S0)).astype(res_dtype))
        rows = (Bc,) if per_chain else (Bc, NB0)
        for pname, lo, hi, inner, dt in (
                ("rc_fir", -900, 900, (n_ch, 8), np.int16),
                ("rc_iir", -900, 900, (n_ch, 8), np.int16),
                ("iir_init", -5000, 5000, (n_ch, 8), np.int32),
                ("shift", 8, 13, (n_ch,), np.int8),
                ("quant", 0, 3, (n_ch,), np.int8),
                ("iir_reset", 0, 2, (n_ch,), np.int8)):
            b.add_host(f"s{s}_{pname}{'_c' if per_chain else ''}",
                       rng.integers(lo, hi, rows + inner).astype(dt))
    b.add_host("mat_coeff", rng.integers(-2**14, 2**14, (F_pad, 6, 8))
               .astype(np.int16))
    b.add_host("mat_noise", rng.integers(-2**10, 2**10, (F_pad, 6, 2))
               .astype(np.int16))
    b.add_host("mat_out", rng.integers(0, C, (F_pad, 6)).astype(np.int8))
    b.add_host("mat_active", (rng.random((F_pad, 6)) < 0.8).astype(np.int8))
    b.mark("mat_mm", 6)
    b.add_host("mat_quant", rng.integers(0, 3, (F_pad, 6)).astype(np.int8))
    b.add_host("out_shift", rng.integers(0, 3, (F_pad, 8)).astype(np.int8))
    b.add_host("wave_perm", rng.permutation(C).astype(np.int8))
    b.add_host("frame_seed", rng.integers(0, 2**32, F_pad, dtype=np.uint64)
               .astype(np.uint32))
    b.add_host("frame_nshift", rng.integers(0, 9, F_pad).astype(np.int8))
    b.add_host("byp", rng.integers(0, 64, T_pad).astype(np.int8))
    b.add_host("jumps", np.array([port_ne._jump_columns(k) for k in range(5)],
                                 dtype=np.uint32))
    (a4, a2, a1), spec = b.finish()
    return (a4, a2, a1), spec


@pytest.mark.parametrize("res_dtype,amp,per_chain", [
    (np.int32, 1 << 20, True), (np.int32, 1 << 20, False),
    (np.int16, 30000, False)])
def test_chunk_program_residual_widths(res_dtype, amp, per_chain):
    """The chunk program on arenas whose residuals are int32 (a stream
    with a residual past int16: the arena builders switch the whole
    array) and int16, per-chain and per-block parameters, against
    dvda_tpu's (int32 output).  The eager front end could not take int32
    residual arenas (a view of a non-contiguous permute)."""
    arenas, spec = _hand_arenas(np.random.default_rng(31), res_dtype, amp,
                                per_chain)
    assert dict((e[0], e[4]) for e in spec)["s0_res"] == np.dtype(
        res_dtype).name
    ref = np.asarray(ne._uniform_arena_pipeline(*arenas, spec))
    got = port_ne.uniform_arena_pipeline(
        *port_ne.arenas_to_device(*arenas, spec, "cpu"), spec).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)

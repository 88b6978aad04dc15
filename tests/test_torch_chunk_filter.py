"""K1a's plain version (the filter of a uniform chunk, read from its
arenas) against the filter output of dvda_tpu's own chunk program.

Each stream of tests/test_torch_chunk.py's STREAMS is parsed and packed
into a partial chunk's arenas by dvda_tpu, in standard mode and in
device-Huffman mode, and dvda_tpu's ``_uniform_arena_pipeline`` records
the arguments of its filter call (native_engine.py:219-222) as
tests/test_torch_chunk_lanes.py does.  dvda_tpu's filter
(``ops.mlp_filter.mlp_filter_blocks_tl``, jitted on the CPU) then runs on
those arguments; in device-Huffman mode both sides take the same random
residual buffer in place of K5's output, which K5's own tests cover.
The port's ``chunk_filter_reference`` on the same arenas must give its
output bit for bit (tolerance 0).  Also: the wrapper on the CPU, its
refusals, K10's wrapper on the CPU against the plain front end, and the
chunk descriptors the kernels read.
"""

import numpy as np
import pytest
import torch

import dvda_tpu.ops.mlp_filter as jax_filter
from dvda_tpu import host
from dvda_tpu_torch.codecs.mlp import native_engine as port_ne
from dvda_tpu_torch.ops import chunk_lanes as cl
from dvda_tpu_torch.ops.chunk_filter import (chunk_filter,
                                             chunk_filter_reference)
from dvda_tpu_torch.ops.chunk_lanes import (chunk_lanes,
                                            chunk_lanes_reference,
                                            chunk_layout)
from dvda_tpu_torch.testutil import CHUNK_LANES_EDGES, chunk_lanes_inputs
from test_torch_chunk import STREAMS
from test_torch_chunk_lanes import _jax_arenas, _record

pytestmark = pytest.mark.skipif(not host.available(),
                                reason="native host library unavailable")

torch.set_num_threads(1)


@pytest.mark.parametrize("huffman", [False, True],
                         ids=["standard", "device_huffman"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_chunk_filter_reference_matches_jax(name, huffman, monkeypatch):
    parse, arenas, spec, words = _jax_arenas(name, huffman, monkeypatch)
    filters, _ = _record(arenas, spec, words, monkeypatch)
    monkeypatch.undo()  # dvda_tpu's own filter again
    (args,) = filters  # every stream fuses: one filter launch
    residuals = None
    if huffman:
        rng = np.random.default_rng(len(name))
        args[0] = rng.integers(-2**23, 2**23, args[0].shape).astype(np.int32)
        residuals = [torch.from_numpy(args[0])]
    want = np.asarray(jax_filter.mlp_filter_blocks_tl(*args)[0])
    port_arenas = port_ne.arenas_to_device(*arenas, spec, "cpu")
    got = chunk_filter_reference(*port_arenas, spec, residuals)
    series = want.reshape(-1, want.shape[-1])  # one launch: [period, lanes]
    assert got.dtype == torch.int32 and tuple(got.shape) == series.shape
    assert np.array_equal(got.numpy(), series)
    # the wrapper on the CPU runs the plain version and counts nothing
    before = chunk_filter.launches
    again = chunk_filter(*port_arenas, spec, residuals)
    assert chunk_filter.launches == before and torch.equal(again, got)
    parse.close()


def test_chunk_filter_residuals_by_mode():
    """A standard chunk's residuals are its arenas'; a device-Huffman
    chunk needs one buffer per filter launch."""
    def inputs(case):
        arenas, spec = chunk_lanes_inputs(case, filter_domain=True)
        return [torch.from_numpy(a) for a in arenas], spec

    std, huff = inputs(CHUNK_LANES_EDGES[0]), inputs(CHUNK_LANES_EDGES[-1])
    arenas, spec = std
    res = chunk_lanes_reference(*arenas, spec).residuals
    with pytest.raises(ValueError, match="in its arenas"):
        chunk_filter(*arenas, spec, res)
    arenas, spec = huff
    assert len(chunk_layout(spec).groups) == 2  # unfused: two launches
    with pytest.raises(ValueError, match="needs 2 residual"):
        chunk_filter(*arenas, spec)
    res = chunk_lanes(*arenas, spec).residuals
    with pytest.raises(ValueError, match="needs 2 residual"):
        chunk_filter(*arenas, spec, res[:1])
    for r in res:
        r.copy_(torch.arange(r.numel(), dtype=torch.int32).view(r.shape))
    got = chunk_filter(*arenas, spec, res)
    periods = {r.shape[0] * r.shape[1] for r in res}
    assert tuple(got.shape) == (*periods, sum(r.shape[2] for r in res))


@pytest.mark.parametrize("case", [c for c in CHUNK_LANES_EDGES if c[4]],
                         ids=lambda c: c[0])
def test_chunk_lanes_wrapper_reference(case):
    """K10's wrapper on the CPU: the plain front end's K5 inputs, places
    and residual shapes, no filter inputs; it refuses a standard chunk."""
    arenas, spec = chunk_lanes_inputs(case)
    a = [torch.from_numpy(x) for x in arenas]
    full = chunk_lanes_reference(*a, spec)
    slim = chunk_lanes(*a, spec)
    assert slim.filters is None and slim.places == full.places
    assert [r.shape for r in slim.residuals] == [f[0].shape
                                                 for f in full.filters]
    for mine, theirs in zip(slim.huffman, full.huffman, strict=True):
        for m, t in zip(mine, theirs, strict=True):
            assert torch.equal(m, t)
    std = chunk_lanes_inputs(CHUNK_LANES_EDGES[0])
    with pytest.raises(ValueError, match="no K5 inputs"):
        chunk_lanes(*map(torch.from_numpy, std[0]), std[1])


@pytest.mark.parametrize("case", CHUNK_LANES_EDGES, ids=lambda c: c[0])
def test_chunk_layout_descriptors(case):
    """The descriptors the kernels read: K10's output regions of a
    device-Huffman chunk each on 256 bytes and apart, inside its buffer,
    and named by each substream's output words (a standard chunk has
    none); each filter launch's descriptor holds its substreams' words
    in lane order."""
    _, spec = chunk_lanes_inputs(case)
    lay = chunk_layout(spec)
    head, words = cl._HEAD_WORDS, cl._SUB_WORDS
    out0 = 6 + 2 * len(cl._IN)
    if not lay.huffman:
        assert lay.n32 == 0 and not lay.regions
    spans = sorted((off, off + int(np.prod(shape)))
                   for off, shape in lay.regions.values())
    for (a, b), (c, _) in zip(spans, spans[1:] + [(lay.n32, None)]):
        assert a % 64 == 0 and b <= c
    assert lay.desc[0] == len(lay.subs)
    for i in range(len(lay.subs)):
        sub = lay.desc[head + i * words : head + (i + 1) * words]
        want = [lay.regions[(k, i)][0] if lay.huffman else 0
                for k in cl._OUT]
        assert list(sub[out0 : out0 + len(cl._OUT)]) == want
    for gd, (_, _, lanes, members) in zip(lay.group_descs, lay.groups,
                                          strict=True):
        assert gd[0] == len(members)
        n = 0
        for j, i in enumerate(members):
            got = gd[head + j * words : head + (j + 1) * words]
            assert np.array_equal(
                got, lay.desc[head + i * words : head + (i + 1) * words])
            n += got[0] * got[2]  # Bc * n_ch
        assert n == lanes

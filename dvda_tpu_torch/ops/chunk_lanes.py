"""The chunk program's arena front end: its plain version, the chunk
descriptor, and kernel K10 (a device-Huffman chunk's K5 inputs).

Port of dvda_tpu/codecs/mlp/native_engine.py:111-267, the part of the
uniform chunk program (``_uniform_arena_pipeline``) between the arenas and
the filter.  From the three chunk arenas (int32/int16/int8) and their
static spec, :func:`chunk_lanes_reference` makes exactly the arrays
dvda_tpu hands its filter, per filter launch (:219-222 after the :239-250
fuse):

  * ``res_tl`` int32 ``[NB0, S0, lanes]``: each substream's residuals
    ``[Bc, NB0, n_ch, S0]`` transposed time-leading, lane ``c*Bc + b``
    (standard mode; in device-Huffman mode K5 writes them);
  * ``rc_fir``, ``rc_iir``, ``iir_init`` int32 ``[lanes, NB0, 8]``;
    ``shift``, ``quant``, ``block_len`` int32 ``[lanes, NB0]``;
    ``iir_reset`` bool ``[lanes, NB0]`` (per-chain rows broadcast over the
    chain's blocks, the reset in block 0 only);
  * the zero initial state int32 ``[lanes, 8]`` (FIR and IIR);

substreams of one ``(NB0, S0)`` fused on the lane axis into one launch,
and in device-Huffman mode K5's int32 lane inputs per substream (bitpos
``[Lc, nsub]``; codebook, lsb_bits, offset, quant ``[Lc, n_ch]``; nbyp
``[Lc]``; ``Lc = Bc*NB0`` chain-major rows; :140-172).  It is the front
half of the plain version of K1a (``ops/chunk_filter.py``), which reads
the filter's inputs from the arenas itself: on the card they are never
made.

:func:`chunk_layout` describes a chunk once per spec: its substreams,
filter launches and the kernels' descriptors.  :func:`chunk_lanes` makes
what K1a does not read, for a device-Huffman chunk: K5's lane inputs and,
per filter launch, the uninitialised ``res_tl`` that K5 fills.  On a CUDA
tensor it launches csrc/chunk_lanes.cu once (every output a view of one
fresh buffer) or raises; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.launch import current_stream, on_cuda, raise_on_error

__all__ = ["ChunkLanes", "check_arenas", "chunk_lanes",
           "chunk_lanes_reference", "chunk_layout"]

#: substreams a chunk may hold (csrc/chunk_lanes.cuh kChunkLanesMaxSubs)
MAX_SUBSTREAMS = 4
#: per-chain (``_c``) or per-block parameter arrays of a substream
_PARAMS = ("rc_fir", "rc_iir", "iir_init", "shift", "quant", "iir_reset")
_HUFFMAN = ("bitpos", "cb", "lsbb", "off", "nbyp")
#: the descriptor's arrays and outputs, in ChunkLanesSub's field order
_IN = ("res",) + _PARAMS + _HUFFMAN
_OUT = ("bitpos", "cb", "lsbb", "off", "hquant", "nbyp")
_SUB_WORDS = 6 + 2 * len(_IN) + len(_OUT) + 3
_HEAD_WORDS = 1  # n_subs
_ALIGN = 64  # every output region starts on 256 bytes


class ChunkLanes(NamedTuple):
    """The front end's outputs for one chunk."""
    #: per filter launch: K1's ten arguments (``res_tl``, ``rc_fir``,
    #: ``rc_iir``, ``shift``, ``quant``, ``iir_reset``, ``iir_init``,
    #: ``block_len``, ``fir_state0``, ``iir_state0``); None from
    #: :func:`chunk_lanes`
    filters: list | None
    #: per substream: K5's lane inputs (``bitpos``, ``codebook``,
    #: ``lsb_bits``, ``offset``, ``quant``, ``nbyp``), None in standard mode
    huffman: list
    #: per substream: (its filter launch, its first lane there)
    places: tuple
    #: per filter launch: the int32 ``res_tl`` [NB0, S0, lanes] (the
    #: first of ``filters``; in device Huffman the buffer K5 fills)
    residuals: list


class _Layout(NamedTuple):
    subs: tuple      # per substream: (Bc, NB0, n_ch, S0, nsub, per_chain)
    groups: tuple    # per filter launch: (NB0, S0, lanes, substreams)
    places: tuple    # per substream: (group, first lane)
    huffman: bool
    regions: dict    # K10's: ("res", g) / ("bitpos", i) ... -> (offset, shape)
    n32: int         # K10's int32 outputs
    need: tuple      # the least length of each arena (4, 2, 1)
    desc: np.ndarray  # the chunk's descriptor (int64 words; K10's)
    #: per filter launch: the descriptor of its substreams alone (K1a's)
    group_descs: tuple


def _signed_width(name: str, entry: tuple) -> int:
    width, dtype = entry[1], entry[4]
    if dtype not in ("int8", "int16", "int32"):
        raise ValueError(f"spec entry {name!r}: dtype {dtype}, expected a "
                         "signed integer")
    return width


@functools.lru_cache(maxsize=64)
def chunk_layout(spec: tuple) -> _Layout:
    """The chunk's substreams, filter launches, K10's output regions (a
    device-Huffman chunk's) and the kernels' descriptors, from its spec
    alone (the spec is static per track geometry, so this runs once per
    geometry)."""
    entries = {e[0]: e for e in spec if e[4] != "flag"}
    flags = {e[0]: e[2] for e in spec if e[4] == "flag"}
    n_sub = max(int(name[1]) for name in entries if name.startswith("s")) + 1
    if n_sub > MAX_SUBSTREAMS:
        raise ValueError(f"{n_sub} substreams: a chunk descriptor holds "
                         f"at most {MAX_SUBSTREAMS}")
    modes = {f"s{i}_bitpos" in entries for i in range(n_sub)}
    if len(modes) != 1:
        raise ValueError("a chunk's substreams mix device-Huffman tables "
                         "and residuals")
    huffman = modes.pop()
    subs, arrays = [], []
    for i in range(n_sub):
        per_chain = f"s{i}_rc_fir_c" in entries
        if huffman:
            Bc, NB0, n_ch = entries[f"s{i}_cb"][3]
            S0 = flags[f"s{i}_S"]
            nsub = entries[f"s{i}_bitpos"][3][2]
        else:
            Bc, NB0, n_ch, S0 = entries[f"s{i}_res"][3]
            nsub = 0
        subs.append((Bc, NB0, n_ch, S0, nsub, per_chain))
        names = {k: f"s{i}_{k}{'_c' if per_chain else ''}" for k in _PARAMS}
        names.update((k, f"s{i}_{k}") for k in ("res",) + _HUFFMAN)
        arrays.append({k: (entries[n][2], _signed_width(n, entries[n]))
                       if n in entries else (0, 0) for k, n in names.items()})
    geoms = {(u[1], u[3]) for u in subs}
    if n_sub > 1 and len(geoms) == 1:  # one (NB0, S0): one fused launch
        members = [tuple(range(n_sub))]
    else:
        members = [(i,) for i in range(n_sub)]

    regions, top = {}, 0

    def region(key, shape):
        nonlocal top
        regions[key] = (top, shape)
        top += -(-int(np.prod(shape)) // _ALIGN) * _ALIGN

    groups, places = [], [None] * n_sub
    for g, m in enumerate(members):
        NB0, S0 = subs[m[0]][1], subs[m[0]][3]
        lanes = 0
        for i in m:
            places[i] = (g, lanes)
            lanes += subs[i][2] * subs[i][0]
        groups.append((NB0, S0, lanes, m))
        if huffman:  # K5's output, K1a's input
            region(("res", g), (NB0, S0, lanes))
    if huffman:
        for i, (Bc, NB0, n_ch, S0, nsub, _) in enumerate(subs):
            Lc = Bc * NB0
            region(("bitpos", i), (Lc, nsub))
            for k in ("cb", "lsbb", "off", "hquant"):
                region((k, i), (Lc, n_ch))
            region(("nbyp", i), (Lc,))
    n32 = top
    if n32 >= 2**31:
        raise ValueError(f"a chunk of {n32} outputs: K10 indexes a "
                         "substream's outputs in 32 bits")

    desc = np.zeros(_HEAD_WORDS + MAX_SUBSTREAMS * _SUB_WORDS, np.int64)
    desc[0] = n_sub
    need = {4: 0, 2: 0, 1: 0}
    for i, (Bc, NB0, n_ch, S0, nsub, per_chain) in enumerate(subs):
        words = [Bc, NB0, n_ch, S0, nsub, int(per_chain)]
        for k in _IN:
            off, width = arrays[i][k]
            words += [off, width]
        # K10's outputs of the substream (none in standard mode)
        words += [regions[(k, i)][0] if huffman else 0 for k in _OUT]
        words += [0] * 3  # the plan
        base = _HEAD_WORDS + i * _SUB_WORDS
        desc[base : base + _SUB_WORDS] = words
    # K1a's: one descriptor per filter launch, its substreams in lane order
    group_descs = []
    for _, _, _, m in groups:
        gd = np.zeros_like(desc)
        gd[0] = len(m)
        for j, i in enumerate(m):
            src = _HEAD_WORDS + i * _SUB_WORDS
            dst = _HEAD_WORDS + j * _SUB_WORDS
            gd[dst : dst + _SUB_WORDS] = desc[src : src + _SUB_WORDS]
        group_descs.append(gd)
    for name, e in entries.items():
        if name.startswith("s") and name[1].isdigit():
            n = int(np.prod(e[3])) if e[3] else 1
            need[e[1]] = max(need[e[1]], e[2] + n)
    return _Layout(tuple(subs), tuple(groups), tuple(places), huffman,
                   regions, n32, (need[4], need[2], need[1]), desc,
                   tuple(group_descs))


def _views(lay: _Layout, out32: torch.Tensor) -> ChunkLanes:
    def view(key):
        off, shape = lay.regions[key]
        return out32.narrow(0, off, int(np.prod(shape))).view(shape)

    return ChunkLanes(None, [tuple(view((k, i)) for k in _OUT)
                             for i in range(len(lay.subs))],
                      lay.places,
                      [view(("res", g)) for g in range(len(lay.groups))])


def _i32(x):
    # .to returns an int32 view as it is (e.g. a per-chain broadcast)
    return x.to(torch.int32).contiguous()


def chunk_lanes_reference(a4, a2, a1, spec) -> ChunkLanes:
    """Plain PyTorch version of the whole front end: dvda_tpu's as eager
    ops on views of the arenas (casts, permutes, broadcasts,
    concatenations), the filter inputs included; in device-Huffman mode
    each launch's ``res_tl`` is a fresh tensor for K5 to fill."""
    lay = chunk_layout(spec)
    arenas = {4: a4, 2: a2, 1: a1}
    arrs = {}
    for name, width, off, shape, dtype in spec:
        if dtype != "flag":
            n = int(np.prod(shape)) if shape else 1
            arrs[name] = arenas[width].narrow(0, off, n).view(shape)
    dev = a4.device
    packed, huffman = [], []
    for i, (Bc, NB0, n_ch, S0, nsub, per_chain) in enumerate(lay.subs):
        lanes, Lc = n_ch * Bc, Bc * NB0

        def pack(x):  # [Bc, NB0, n_ch, ...] → [n_ch*Bc, NB0, ...]
            g = x.movedim(2, 0)          # channel-major lane order
            return g.reshape((lanes, NB0) + tuple(x.shape[3:]))

        if per_chain:
            # per-chain parameter rows broadcast across the chain's blocks
            def bc(x):
                return x[:, None].expand((Bc, NB0) + tuple(x.shape[1:]))

            rc_fir, rc_iir, shift, quant, iir_init = (
                bc(arrs[f"s{i}_{k}_c"]) for k in
                ("rc_fir", "rc_iir", "shift", "quant", "iir_init"))
            iir_reset = torch.zeros((Bc, NB0, n_ch), dtype=torch.bool,
                                    device=dev)
            iir_reset[:, 0] = arrs[f"s{i}_iir_reset_c"] != 0
        else:
            rc_fir, rc_iir, shift, quant, iir_init = (
                arrs[f"s{i}_{k}"] for k in
                ("rc_fir", "rc_iir", "shift", "quant", "iir_init"))
            iir_reset = arrs[f"s{i}_iir_reset"] != 0
        if lay.huffman:
            res_tl = None
            huffman.append((
                _i32(arrs[f"s{i}_bitpos"]).view(Lc, nsub),
                *(_i32(arrs[f"s{i}_{k}"]).view(Lc, n_ch)
                  for k in ("cb", "lsbb", "off")),
                _i32(quant).view(Lc, n_ch),
                _i32(arrs[f"s{i}_nbyp"]).view(Lc)))
        else:
            huffman.append(None)
            res = arrs[f"s{i}_res"]
            res_tl = _i32(res.permute(1, 3, 2, 0).reshape(NB0, S0, lanes))
        packed.append((res_tl, _i32(pack(rc_fir)), _i32(pack(rc_iir)),
                       _i32(pack(shift)), _i32(pack(quant)),
                       pack(iir_reset).contiguous(), _i32(pack(iir_init)),
                       torch.full((lanes, NB0), S0, dtype=torch.int32,
                                  device=dev)))
    filters, residuals = [], []
    for NB0, S0, lanes, members in lay.groups:
        if lay.huffman:
            residuals.append(torch.empty((NB0, S0, lanes), dtype=torch.int32,
                                         device=dev))
        else:  # time-leading residuals: lanes concatenate on axis 2
            residuals.append(torch.cat([packed[i][0] for i in members], 2))
        state0 = torch.zeros((lanes, 8), dtype=torch.int32, device=dev)
        filters.append((residuals[-1],
                        *(torch.cat([packed[i][j] for i in members])
                          for j in range(1, 8)), state0, state0))
    return ChunkLanes(filters, huffman, lay.places, residuals)


def check_arenas(a4, a2, a1, lay: _Layout) -> None:
    """Raise unless the three arenas are contiguous 1-D int32 / int16 /
    int8 tensors on one device, each as long as the spec reads."""
    dev = a4.device
    for t, w, dtype, need in ((a4, 4, torch.int32, lay.need[0]),
                              (a2, 2, torch.int16, lay.need[1]),
                              (a1, 1, torch.int8, lay.need[2])):
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"arena {w}: expected a tensor on {dev}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"arena {w}: expected a contiguous 1-D {dtype}")
        if t.numel() < need:
            raise ValueError(f"arena {w}: {t.numel()} elements, the spec "
                             f"reads {need}")


def _launch(a4, a2, a1, lay: _Layout) -> ChunkLanes:
    from ..kernels.build import kernel_library

    dev = a4.device
    check_arenas(a4, a2, a1, lay)
    out32 = torch.empty(lay.n32, dtype=torch.int32, device=dev)
    lib = kernel_library()
    with torch.cuda.device(dev):
        rc = lib.dvda_chunk_lanes(
            lay.desc.ctypes.data, lay.desc.size, a4.data_ptr(),
            a2.data_ptr(), a1.data_ptr(), out32.data_ptr(),
            current_stream(dev))
        chunk_lanes.launches += 1
    if rc == -1:
        raise ValueError("chunk_lanes: the kernel refused the descriptor "
                         "(its layout differs from csrc/chunk_lanes.cuh)")
    raise_on_error(rc, "chunk_lanes")
    return _views(lay, out32)


def chunk_lanes(a4, a2, a1, spec) -> ChunkLanes:
    """A device-Huffman chunk's K5 lane inputs per substream and, per
    filter launch, the residual buffer K5 fills (see the module note),
    from its arenas and spec; ``filters`` is None.  CUDA arenas go
    through kernel K10 (one launch)."""
    lay = chunk_layout(spec)
    if not lay.huffman:
        raise ValueError("chunk_lanes: a standard chunk has no K5 inputs; "
                         "its filter reads the arenas (chunk_filter)")
    if on_cuda(a4):
        return _launch(a4, a2, a1, lay)
    return chunk_lanes_reference(a4, a2, a1, spec)._replace(filters=None)


#: kernel launches since the last reset (the CPU path never counts)
chunk_lanes.launches = 0

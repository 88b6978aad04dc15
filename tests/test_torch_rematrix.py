"""The port's fused output stage (kernel K234's plain version on the CPU)
against dvda_tpu's rematrix_frames_tl + apply_output_stage_tl, with the
noise from dvda_tpu's LFSR and the chunk program's byte pack; and the
port's numpy LFSR against dvda_tpu's.  Bit-exact (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvda_tpu.ops import lfsr as jax_lfsr
from dvda_tpu.ops.rematrix import apply_output_stage_tl, rematrix_frames_tl
from dvda_tpu_torch.ops import lfsr
from dvda_tpu_torch.ops.rematrix import output_stage
from dvda_tpu_torch.testutil import (NARROW_EDGES, OUTPUT_STAGE_EDGES,
                                     output_stage_inputs)

torch.set_num_threads(1)

Fc, L, C, Bc = 4, 8, 8, 8


def _jax_output_stage(inp, n_mats, nbytes, shape=(Fc, L, C, Bc), tier=0):
    """The JAX package's stages on the same arena arrays: noise per frame
    from dvda_tpu.ops.lfsr, bypass bits, rematrix, output stage, pack;
    with ``tier``, the chunk program's narrow pack and flag rows
    (dvda_tpu/codecs/mlp/native_engine.py:345-369)."""
    Fc, L, C, Bc = shape

    def tlf(x):  # chain-major [Bc*Fc, ...] → [Fc, ..., Bc]
        return np.moveaxis(x.reshape((Bc, Fc) + x.shape[1:]), 0, -1)

    channels = inp["series"].reshape(Fc, L, C, Bc)
    if C < 8:
        channels = np.concatenate(
            [channels, np.zeros((Fc, L, 8 - C, Bc), np.int32)], 2)
    seeds = tlf(inp["frame_seed"].view(np.uint32))
    nshift = tlf(inp["frame_nshift"])
    noise = np.zeros((Fc, L, 2, Bc), np.int32)
    for f in range(Fc):
        for b in range(Bc):
            n0, n1, _ = jax_lfsr.noise_pair(int(seeds[f, b]), L,
                                            int(nshift[f, b]))
            noise[f, :, 0, b], noise[f, :, 1, b] = n0, n1
    byp = inp["byp"].astype(np.int32).reshape(Bc, Fc * L).T.reshape(Fc, L, Bc)
    bits = (byp[:, :, None, :] >> np.arange(6)[None, None, :, None]) & 1
    i32 = np.int32
    ch = rematrix_frames_tl(
        jnp.asarray(channels), jnp.asarray(noise),
        jnp.asarray(tlf(inp["mat_coeff"]).astype(i32)),
        jnp.asarray(tlf(inp["mat_noise"]).astype(i32)),
        jnp.asarray(tlf(inp["mat_out"]).astype(i32)),
        jnp.asarray(tlf(inp["mat_active"]) != 0),
        jnp.asarray(tlf(inp["mat_quant"]).astype(i32)),
        jnp.asarray(bits.astype(i32)), n_mats)
    staged = np.asarray(apply_output_stage_tl(
        ch, jnp.asarray(tlf(inp["out_shift"]).astype(i32)),
        jnp.asarray(inp["wave_perm"].astype(i32))))
    rows = staged.transpose(3, 0, 1, 2).reshape(Bc * Fc * L, -1)
    if tier:
        lo, hi = rows.min(), rows.max()
        fits16 = int(lo >= -(1 << 15) and hi < (1 << 15))
        if tier == 12:
            c0, c1 = rows[:, 0::2], rows[:, 1::2]
            pk = np.stack([c0 & 0xFF, ((c0 >> 8) & 0xF) | ((c1 & 0xF) << 4),
                           (c1 >> 4) & 0xFF], 2)
            flag = int(lo >= -(1 << 11) and hi < (1 << 11)) + 2 * fits16
        else:
            pk = np.stack([rows & 0xFF, (rows >> 8) & 0xFF], 2)
            flag = fits16
        narrow = pk.astype(np.uint8).reshape(rows.shape[0], -1)
        return np.concatenate([narrow, np.full((8, narrow.shape[1]), flag,
                                               np.uint8)])
    if nbytes == 0:
        return rows
    pk = np.stack([(rows >> (8 * k)) & 0xFF for k in range(nbytes)], 2)
    return pk.astype(np.uint8).reshape(rows.shape[0], -1)


@pytest.mark.parametrize("seed,extreme,c_out,nbytes", [
    (0, False, 8, 0),
    (1, True, 8, 0),
    (2, True, 6, 3),
    (3, False, 6, 2),
])
def test_output_stage_matches_jax(seed, extreme, c_out, nbytes):
    inp = output_stage_inputs(seed, Bc, Fc, L, C, c_out, extreme=extreme)
    got = output_stage(*map(torch.from_numpy, inp.values()), chains=Bc,
                       n_mats=6, nbytes=nbytes).numpy()
    assert np.array_equal(got, _jax_output_stage(inp, 6, nbytes))


def test_output_stage_fewer_matrices():
    """n_mats below 6 runs only the leading slots (the chunk's mat_mm)."""
    inp = output_stage_inputs(5, Bc, Fc, L, C, 6, n_active=2)
    got = output_stage(*map(torch.from_numpy, inp.values()), chains=Bc,
                       n_mats=2, nbytes=3).numpy()
    assert np.array_equal(got, _jax_output_stage(inp, 2, 3))


@pytest.mark.parametrize("case", [(s, 0) for s in OUTPUT_STAGE_EDGES]
                         + list(NARROW_EDGES),
                         ids=lambda c: "-".join(map(str, c[0])) + f"-t{c[1]}")
def test_output_stage_edges_match_jax(case):
    """K234's (tier 0) and K234n's edge shapes (testutil's
    OUTPUT_STAGE_EDGES, NARROW_EDGES), the plain version against the JAX
    stages: ragged chain tiles and strips, C_tot 1 and 8, 0-6 slots,
    every form and both narrow tiers with their flag rows."""
    (Bc_, fpc, L0, C_tot, C_out, n_mats, nbytes, extreme), tier = case
    nbytes = 3 if tier else nbytes
    inp = output_stage_inputs(L0 + n_mats, Bc_, fpc, L0, C_tot, C_out,
                              extreme=extreme)
    got = output_stage(*map(torch.from_numpy, inp.values()), chains=Bc_,
                       n_mats=n_mats, nbytes=nbytes, tier=tier).numpy()
    ref = _jax_output_stage(inp, n_mats, nbytes, (fpc, L0, C_tot, Bc_),
                            tier)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed", [0x1234567, 0xDEADBEEF, 1])
def test_lfsr_matches_jax(seed):
    for n, shift in ((80, 0), (33, 5), (1, 15)):
        got = lfsr.noise_pair(seed, n, shift)
        ref = jax_lfsr.noise_pair(seed, n, shift)
        assert np.array_equal(got[0], ref[0])
        assert np.array_equal(got[1], ref[1])
        assert got[2] == ref[2]
    assert all(lfsr._jump_columns(k) == jax_lfsr._jump_columns(k)
               for k in range(8))

"""The port's AR filter (kernel K1's plain version on the CPU) against
dvda_tpu's lax.scan filter and its Pallas kernel (interpret mode).

Same numpy inputs into both packages; every comparison is bit-exact
(tolerance 0), because the filter is integer arithmetic with C semantics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvda_tpu.ops.mlp_filter import mlp_filter_blocks as jax_filter
from dvda_tpu.ops.mlp_filter import mlp_filter_blocks_tl as jax_filter_tl
from dvda_tpu.ops.pallas_filter import mlp_filter_blocks_pallas
from dvda_tpu_torch.ops.mlp_filter import (mlp_filter_blocks,
                                           mlp_filter_blocks_tl,
                                           mlp_filter_frames)
from dvda_tpu_torch.testutil import FILTER_EDGES, filter_inputs

torch.set_num_threads(1)


def _lane_leading(args):
    """filter_inputs' time-leading residuals → the lane-leading layout."""
    return (np.ascontiguousarray(args[0].transpose(2, 0, 1)),) + args[1:]


def _port(fn, args):
    cpu = [torch.from_numpy(np.asarray(a)) for a in args]
    return [t.numpy() for t in fn(*cpu)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_matches_scan_and_pallas(seed):
    args = _lane_leading(filter_inputs(seed, 128, 4, 16))
    got, fir_f, iir_f = _port(mlp_filter_blocks, args)
    jargs = tuple(map(jnp.asarray, args))
    ref, rfir, riir = jax_filter(*jargs)
    assert np.array_equal(got, np.asarray(ref))
    assert np.array_equal(fir_f, np.asarray(rfir))
    assert np.array_equal(iir_f, np.asarray(riir))
    pal = mlp_filter_blocks_pallas(*jargs[:8], interpret=True)
    assert np.array_equal(got, np.asarray(pal))


def test_filter_extreme_values():
    """Full-range int32 residuals and 16-bit taps: the wrapping adds and
    shifts must match the limb arithmetic of both JAX versions."""
    args = _lane_leading(filter_inputs(9, 128, 2, 8, extreme=True))
    got = _port(mlp_filter_blocks, args)[0]
    jargs = tuple(map(jnp.asarray, args))
    assert np.array_equal(got, np.asarray(jax_filter(*jargs)[0]))
    pal = mlp_filter_blocks_pallas(*jargs[:8], interpret=True)
    assert np.array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("seed", [3, 4])
def test_filter_tl_initial_states(seed):
    """Time-leading entry with nonzero initial FIR/IIR states: outputs and
    final states equal mlp_filter_blocks_tl's."""
    args = filter_inputs(seed, 64, 3, 12, states=True)
    got = _port(mlp_filter_blocks_tl, args)
    ref = jax_filter_tl(*map(jnp.asarray, args))
    for g, r in zip(got, ref):
        assert np.array_equal(g, np.asarray(r))


@pytest.mark.parametrize("shape", FILTER_EDGES[:6],
                         ids=lambda s: "-".join(map(str, s)))
def test_filter_none_states_are_zero(shape):
    """The lane-leading entry with ``None`` initial states (the engine's
    call) equals dvda_tpu's with zero states: output and final states."""
    B, NB, S, extreme, _ = shape
    args = _lane_leading(filter_inputs(B + S, B, NB, S, extreme))
    assert not args[8].any() and not args[9].any()
    got = _port(lambda *a: mlp_filter_blocks(*a[:8], None, None), args)
    ref = jax_filter(*map(jnp.asarray, args))
    for g, r in zip(got, ref, strict=True):
        assert np.array_equal(g, np.asarray(r))


@pytest.mark.parametrize("F,C,NB,S,extreme", [
    (4, 8, 3, 16, False), (5, 6, 2, 7, True), (3, 3, 4, 10, True),
    (1, 1, 1, 1, False)])
def test_filter_frames_matches_step_filter(F, C, NB, S, extreme):
    """``mlp_filter_frames`` equals the filter half of dvda_tpu's
    ``decode_step`` (parallel/step.py:63-72): the lane-leading filter from
    zero states, then ``out.reshape(F, C, NB*S).transpose(0, 2, 1)``.
    (The extremes are 16-bit taps: dvda_tpu's filter is not defined for
    full-range ones, which no MLP stream has.)"""
    args = _lane_leading(filter_inputs(F + C + S, F * C, NB, S, extreme))
    lanes = [a.reshape((F, C) + a.shape[1:]) for a in args[:8]]
    got = mlp_filter_frames(*map(torch.from_numpy, lanes)).numpy()
    out, _, _ = jax_filter(*map(jnp.asarray, args[:8]),
                           jnp.zeros((F * C, 8), jnp.int32),
                           jnp.zeros((F * C, 8), jnp.int32))
    ref = np.asarray(out).reshape(F, C, NB * S).transpose(0, 2, 1)
    assert got.shape == (F, NB * S, C) and got.dtype == np.int32
    assert np.array_equal(got, ref)

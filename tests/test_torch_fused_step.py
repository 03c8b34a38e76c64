"""Port parity: the pipe vector phases and the full-DIA whole-iteration step
against the JAX package's Pallas kernels in interpret mode.

The port runs the plain PyTorch versions (CPU tensors); both sides in
float64 on inputs from a numpy seed.  Vectors agree to rtol 1e-12 of the
vector's scale, dots to rtol 1e-11 of ``sum |a_i b_i|`` (the JAX kernels sum
the products lane-wise per tile, torch in one pass).  The whole-iteration
step is also held to the port's own split formulation (vector phase, then the
SpMV) at sizes the JAX kernel does not take (ragged n, n below one tile).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.ops import fused_step as jfs
from new_cg_variants_tpu_torch.ops import fused_step as tfs
from new_cg_variants_tpu_torch.ops import spmv_dia as tsp
from new_cg_variants_tpu_torch.ops.operators import DiaOperator
from new_cg_variants_tpu_torch.solvers.context import (
    Context,
    split_pipe_full_step,
)
from test_torch_operators import random_dia

VEC_RTOL = 1e-12
DOT_RTOL = 1e-11
A1, BETA = 0.37, 0.12
UNPREC = "x r w u p s".split()
PREC = UNPREC + "rt st wt ut".split()


def _state(names, n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(n) for k in names}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(got, want, dot_pairs):
    """``got`` / ``want``: vector outputs followed by the tuple of dots;
    ``dot_pairs``: for each dot the indices of its two output vectors."""
    *gv, gd = got
    *wv, wd = want
    assert len(gv) == len(wv) and len(gd) == len(wd) == len(dot_pairs)
    for g, w in zip(gv, wv):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=VEC_RTOL,
                                   atol=VEC_RTOL * np.abs(w).max())
    for g, w, (i, j) in zip(gd, wd, dot_pairs):
        scale = float(np.abs(np.asarray(wv[i]) * np.asarray(wv[j])).sum())
        np.testing.assert_allclose(float(g), float(w), rtol=0,
                                   atol=DOT_RTOL * scale)


@pytest.mark.parametrize("n", [4096, 5000, 777])
def test_vector_phase_matches_jax_kernel(n):
    sv = _state(UNPREC, n, seed=n)
    want = jfs.fused_pipe_vector_phase(
        *[jnp.asarray(sv[k]) for k in UNPREC], jnp.asarray(A1),
        jnp.asarray(BETA), tile=1024, interpret=True)
    got = tfs.fused_pipe_vector_phase(*[_t(sv[k]) for k in UNPREC], A1, BETA)
    # x2 r2 w2 p2 s2; dots p2.s2 r2.s2 s2.s2 r2.r2
    _assert_same(got, want, [(3, 4), (1, 4), (4, 4), (1, 1)])
    # 0-d tensor scalars are taken as well as Python floats
    again = tfs.fused_pipe_vector_phase(
        *[_t(sv[k]) for k in UNPREC], torch.tensor(A1, dtype=torch.float64),
        torch.tensor(BETA, dtype=torch.float64))
    for g, a in zip(got[:-1], again[:-1]):
        np.testing.assert_array_equal(g.numpy(), a.numpy())


@pytest.mark.parametrize("n", [4096, 5000, 777])
def test_vector_phase_prec_matches_jax_kernel(n):
    sv = _state(PREC, n, seed=n + 1)
    want = jfs.fused_pipe_vector_phase_prec(
        *[jnp.asarray(sv[k]) for k in PREC], jnp.asarray(A1),
        jnp.asarray(BETA), tile=1024, interpret=True)
    got = tfs.fused_pipe_vector_phase_prec(*[_t(sv[k]) for k in PREC], A1,
                                           BETA)
    # x2 r2 w2 rt2 wt2 p2 s2 st2; dots p2.s2 r2.st2 st2.s2 rt2.r2
    _assert_same(got, want, [(5, 6), (1, 7), (7, 6), (3, 1)])


@pytest.mark.parametrize("recompute", [True, False], ids=["pr", "p"])
@pytest.mark.parametrize("n,offsets", [
    (4096, tuple(range(-31, 32))),
    (8192, tuple(range(-31, 32))),
    (8192, (-3, -1, 0, 2, 7)),
    (4096, (-400, 0, 100)),
], ids=str)
def test_full_step_matches_jax_kernel(n, offsets, recompute):
    data = random_dia(n, offsets, seed=n)
    sv = _state(UNPREC, n, seed=n + 2)
    assert jfs.supports_full_step(offsets, n, tile=2048)
    assert tfs.supports_full_step(offsets)
    want = jfs.fused_pipe_full_step(
        offsets, jnp.asarray(data), *[jnp.asarray(sv[k]) for k in UNPREC],
        jnp.asarray(A1), jnp.asarray(BETA), recompute=recompute, tile=2048,
        interpret=True)
    got = tfs.fused_pipe_full_step(
        offsets, _t(data), *[_t(sv[k]) for k in UNPREC], A1, BETA,
        recompute=recompute)
    # x2 r2 w_out p2 s2 u2; dots p2.s2 r2.s2 s2.s2 r2.r2
    _assert_same(got, want, [(3, 4), (1, 4), (4, 4), (1, 1)])


@pytest.mark.parametrize("recompute", [True, False], ids=["pr", "p"])
@pytest.mark.parametrize("n,offsets", [
    (4099, tuple(range(-31, 32))),     # ragged n
    (100, tuple(range(-7, 8))),        # n below one tile of either package
    (1000, (-2048, -1, 0, 1, 2048)),   # offsets wider than n
], ids=str)
def test_full_step_is_the_split_formulation(n, offsets, recompute):
    """Bit for bit on the CPU: the same torch expressions in the same order."""
    data = random_dia(n, offsets, seed=n)
    op = DiaOperator(offsets, _t(data))
    s_ = {k: _t(v) for k, v in _state(UNPREC, n, seed=n + 3).items()}
    a1 = torch.tensor(A1, dtype=torch.float64)
    beta = torch.tensor(BETA, dtype=torch.float64)
    want = split_pipe_full_step(Context(op), s_, a1, beta, recompute)
    got = tfs.fused_pipe_full_step(offsets, op.data, *[s_[k] for k in UNPREC],
                                   a1, beta, recompute=recompute)
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for g, w in zip(got[-1], want[-1]):
        assert float(g) == float(w)


def test_supports_full_step_reads_the_offsets_only():
    assert tfs.supports_full_step(tuple(range(-31, 32)))
    assert tfs.supports_full_step((-256, 0, 256))
    assert tfs.supports_full_step((0, tfs.MAX_FULL_STEP_HALO))
    assert not tfs.supports_full_step((-257, 0, 256))
    assert not tfs.supports_full_step((-2048, -1, 0, 1, 2048))
    # what the whole-iteration kernel takes, the SpMV kernel stages too
    assert tfs.MAX_FULL_STEP_HALO <= tsp.MAX_STAGED_HALO


def test_cpu_path_does_not_count_launches_and_mixed_devices_raise():
    n = 300
    sv = {k: _t(v) for k, v in _state(PREC, n, seed=0).items()}
    before = [fn.launches for fn in tfs.FUSED_STEP_WRAPPERS]
    tfs.fused_pipe_vector_phase(*[sv[k] for k in UNPREC], A1, BETA)
    tfs.fused_pipe_vector_phase_prec(*[sv[k] for k in PREC], A1, BETA)
    tfs.fused_pipe_full_step((-1, 0, 1), _t(random_dia(n, (-1, 0, 1), 0)),
                             *[sv[k] for k in UNPREC], A1, BETA)
    assert [fn.launches for fn in tfs.FUSED_STEP_WRAPPERS] == before
    meta = torch.empty(n, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="all-CUDA or all-CPU"):
        tfs.fused_pipe_vector_phase(meta, *[sv[k] for k in UNPREC[1:]], A1,
                                    BETA)

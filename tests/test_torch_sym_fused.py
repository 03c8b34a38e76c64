"""Port parity: the fused half-band pipe step against the JAX package.

The port's ``fused_sym_pipe_full_step`` takes its plain PyTorch version on
CPU tensors (the CUDA kernel is held against that same version on the card by
``chip_smoke.py``).  Here it is compared in float64 with the JAX Pallas kernel
in interpret mode, from one random state, and with the port's own split
formulation (vector phase + ``mv2``).  The mirror sums run in another order
than the JAX kernel's roll-and-spill decomposition, so agreement is to
rtol 1e-12 normwise, not bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.matio.problems import banded_model as jax_banded
from new_cg_variants_tpu.ops import sym_fused as jsf
from new_cg_variants_tpu.solvers.context import Context as JaxContext
from new_cg_variants_tpu.solvers.context import (
    generic_pipe_vector_phase as jax_vector_phase,
)
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.ops import sym_fused as tsf
from new_cg_variants_tpu_torch.solvers.context import (
    Context,
    split_pipe_full_step,
)

RTOL = 1e-12
N, K = 4096, 32
A1, BETA = 0.37, 0.61
NAMES = ("x2", "r2", "w_out", "p2", "s2", "u2")


@pytest.fixture(scope="module")
def problem():
    jop, _, _ = jax_banded(N, k=K, kappa=1e4, fmt="symdia")
    top = operator_from_numpy(jop.offsets, np.asarray(jop.data), device="cpu")
    rng = np.random.default_rng(2024)
    vecs = [rng.standard_normal(N) for _ in range(6)]
    return jop, top, vecs


def _close_vectors(got, want, data_rowsum):
    # normwise per entry: |A| |v| bounds the rounding of each matvec row,
    # and O(1) random inputs bound the elementwise updates
    for name, g, w in zip(NAMES, got, want):
        scale = data_rowsum if name in ("u2", "w_out") else 1.0
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * scale * np.abs(w).max(),
                                   err_msg=name)


def _close_dots(got, want, pairs):
    for g, w, (a, b) in zip(got, want, pairs):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * np.dot(np.abs(a), np.abs(b)))


@pytest.mark.parametrize("recompute", [True, False])
def test_fused_step_matches_jax_kernel(problem, recompute):
    jop, top, vecs = problem
    jout = jsf.fused_sym_pipe_full_step(
        jop.offsets, jop.data, *[jnp.asarray(v) for v in vecs],
        jnp.asarray(A1), jnp.asarray(BETA), recompute=recompute, tile=1024,
        interpret=True)
    tout = tsf.fused_sym_pipe_full_step(
        top.offsets, top.data, *[torch.from_numpy(v) for v in vecs],
        torch.tensor(A1, dtype=torch.float64),
        torch.tensor(BETA, dtype=torch.float64), recompute=recompute)
    jvec = [np.asarray(a) for a in jout[:6]]
    tvec = [t.numpy() for t in tout[:6]]
    _close_vectors(tvec, jvec, 1.0)
    _, r2, _, p2, s2, _ = jvec
    pairs = ((p2, s2), (r2, s2), (s2, s2), (r2, r2))
    _close_dots([float(d) for d in tout[6]], [float(d) for d in jout[6]],
                pairs)
    if not recompute:
        # without recompute w_out is the updated w, no matvec
        np.testing.assert_allclose(tvec[2], vecs[2] - A1 * vecs[3],
                                   rtol=RTOL, atol=RTOL)


def _jax_generic_step(jop, vecs, recompute):
    """JAX's split formulation: generic vector phase, then mv2 / mv."""
    x2, r2, w2, p2, s2, dots = jax_vector_phase(
        JaxContext(jop), *[jnp.asarray(v) for v in vecs], A1, BETA)
    if recompute:
        u2, w_out = jop.mv2(s2, r2)
    else:
        u2, w_out = jop.mv(s2), w2
    return [np.asarray(a) for a in (x2, r2, w_out, p2, s2, u2)], dots


@pytest.mark.parametrize("recompute", [True, False])
def test_split_path_matches_fused_and_jax_generic(problem, recompute):
    jop, top, vecs = problem
    ctx = Context(top)
    state = dict(zip(("x", "r", "w", "u", "p", "s"),
                     (torch.from_numpy(v) for v in vecs)))
    a1 = torch.tensor(A1, dtype=torch.float64)
    beta = torch.tensor(BETA, dtype=torch.float64)
    split = split_pipe_full_step(ctx, state, a1, beta, recompute)
    fused = ctx.pipe_full_step(state, a1, beta, recompute)
    jvec, jdots = _jax_generic_step(jop, vecs, recompute)
    r2, p2, s2 = (fused[i].numpy() for i in (1, 3, 4))
    pairs = ((p2, s2), (r2, s2), (s2, s2), (r2, r2))
    for other, other_dots in (([t.numpy() for t in fused[:6]], fused[6]),
                              (jvec, jdots)):
        _close_vectors([t.numpy() for t in split[:6]], other, 1.0)
        _close_dots([float(d) for d in split[6]],
                    [float(d) for d in other_dots], pairs)


def test_fused_step_outputs_are_new_tensors(problem):
    _, top, vecs = problem
    ins = [torch.from_numpy(v.copy()) for v in vecs]
    before = [t.clone() for t in ins]
    zero = torch.tensor(0.0, dtype=torch.float64)
    outs = tsf.fused_sym_pipe_full_step(top.offsets, top.data, *ins, zero,
                                        zero, recompute=True)
    for t, b in zip(ins, before):
        assert torch.equal(t, b)
    ptrs = {t.data_ptr() for t in ins}
    # x2 = x and r2 = r and s2 = w when a1 = beta = 0, but never the same
    # storage: a neighbour block on the card still reads the old vectors
    assert not ptrs & {t.data_ptr() for t in outs[:6] if t.numel()}


def test_cpu_path_does_not_count_launches(problem):
    _, top, vecs = problem
    before = tsf.fused_sym_pipe_full_step.launches
    zero = torch.tensor(0.5, dtype=torch.float64)
    tsf.fused_sym_pipe_full_step(top.offsets, top.data,
                                 *[torch.from_numpy(v) for v in vecs], zero,
                                 zero)
    assert tsf.fused_sym_pipe_full_step.launches == before


def test_mixed_devices_raise(problem):
    _, top, vecs = problem
    meta = [torch.empty(N, dtype=torch.float64, device="meta")] * 6
    with pytest.raises(ValueError):
        tsf.fused_sym_pipe_full_step(top.offsets, top.data, *meta, 0.1, 0.1)

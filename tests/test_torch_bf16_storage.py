"""Port parity: the bf16 storage tier.

bf16 is a storage-only tier in both packages: the matrix data is stored in
bf16 while vectors, scalars, dots and all arithmetic stay float32
(``solvers/api.py:_vector_dtype``).  The JAX package's Pallas kernels widen
the band at register level; the port's CUDA kernels load each band value as
bf16 and widen it (``csrc/storage.cuh``), and their plain PyTorch versions,
which run here on the CPU, promote the bf16 x float32 products to float32 as
XLA does.  Inputs come from a numpy seed and are rounded to bf16 by each
package's own ``astype`` (bit for bit the same, held below).  What is held:

* the port counterparts of ``tests/test_bf16_storage.py`` with its asserts,
  the JAX run beside;
* each band module's plain version on bf16 data against the JAX package's
  Pallas kernel in interpret mode (rows 1, 2 / 2b, 3, 6, 7, 8) and the ELL
  product against the JAX ``EllOperator``'s XLA path (row 12): float32
  results within 1e-6 of each output's largest magnitude (the two sum in
  another order in float32);
* every variant name on bf16 half-band, full-DIA and ELL operators, and
  pipe-PR-CG / hs-PCG on bf16 dense and block-banded operators, against the
  JAX package: nu and alpha within rtol 1e-4 through iteration 15 (two
  float32 summation orders drift apart from there on), and over 40
  iterations the smallest relative residual within 0.5 in log10 (the
  outcome: at the rounding floor the residual is rounding noise, and the
  pipe_p_m names diverge there, in both packages);
* the dense and block-banded operators solve on bf16 storage (the products
  widen the stored blocks; nothing keeps a float32 copy), and
  ``from_coo(fmt="auto", dtype=bf16)`` at n = 512 solves as the JAX
  package does;
* the CUDA wrappers' argument rules on bf16 data, with stand-ins for CUDA
  tensors (the kernels themselves run only on the card: ``chip_smoke.py``
  holds each bf16 entry to its plain version and, bit for bit, to the
  float32 entry on the widened data).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import new_cg_variants_tpu as cgt
from new_cg_variants_tpu.ops import fused_family as jff
from new_cg_variants_tpu.ops import fused_step as jfs
from new_cg_variants_tpu.ops import operators as jo
from new_cg_variants_tpu.ops import spmv_pallas as jsp
from new_cg_variants_tpu.ops import sym_dia as jsd
from new_cg_variants_tpu.ops import sym_fused as jsf
from new_cg_variants_tpu.ops.sym_dia import SymDiaOperator as JaxSymDia
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.convert import operator_from_numpy
from new_cg_variants_tpu_torch.ops import _kernels
from new_cg_variants_tpu_torch.ops import ell_spmv as tes
from new_cg_variants_tpu_torch.ops import fused_family as tff
from new_cg_variants_tpu_torch.ops import fused_step as tfs
from new_cg_variants_tpu_torch.ops import operators as to
from new_cg_variants_tpu_torch.ops import spmv_dia as tsp
from new_cg_variants_tpu_torch.ops import sym_dia as tsd
from new_cg_variants_tpu_torch.ops import sym_fused as tsf
from new_cg_variants_tpu_torch.ops.block_banded import (
    PermutedBlockBandedOperator,
)
from test_torch_sparse_variants import both, grid9, laplacian
from test_torch_sym_family import _FakeCudaTensor
from test_torch_variants import scaled_band

BF16 = torch.bfloat16
KERNEL_RTOL = 1e-6
HIST_RTOL = 1e-4
HIST_ROWS = 16
OUTCOME_ITERS = 40
OUTCOME_LOG10_TOL = 0.5
#: an A-norm error history, relative to its first row, is formed in float32
#: from x - x_true: below ~1e-3 its rows carry absolute noise near
#: eps_f32 sqrt(kappa) ~ 1e-6 (of the first row) in either package
ERROR_ATOL = 1e-5
A1, BETA = 0.37, 0.61


def _bits(t):
    """A bf16 array's bits, from either package."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and want.dtype == np.float32, err_msg
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=KERNEL_RTOL * np.abs(want).max(),
                               err_msg=err_msg)


def _band(offsets, n, seed):
    """O(1) random band values, zeros outside the matrix, in float64."""
    data = np.random.default_rng(seed).uniform(-1.0, 1.0, (len(offsets), n))
    for d, off in enumerate(offsets):
        if off > 0:
            data[d, max(n - off, 0):] = 0.0
        elif off < 0:
            data[d, :min(-off, n)] = 0.0
    return data


def _bf16_pair(data):
    """``data`` (float64) rounded to bf16 by each package."""
    jd = jnp.asarray(data).astype(jnp.bfloat16)
    td = torch.from_numpy(np.ascontiguousarray(data)).to(BF16)
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    return jd, td


def _vectors(names, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0.5, 2.0, n) if nm == "inv_diag"
             else rng.standard_normal(n)).astype(np.float32) for nm in names]


def _signature(fn):
    """``(vector argument names, scalar argument names)`` of an entry."""
    params = list(inspect.signature(fn).parameters)[2:]
    scalars = [p for p in params if p in ("a1", "beta")]
    vecs = [p for p in params if p not in scalars + ["recompute", "tile",
                                                      "interpret"]]
    return vecs, scalars


# ---------------------------------------------------------------------------
# rounding to bf16


def test_astype_bits_match_jax():
    """Both packages round float64 to bf16 alike: random values over 40
    decades, and values at, just above and just below the ties between two
    bf16 neighbours (exact in float32, so a rounding through float32 lands
    on the tie)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(200_000) * 10.0 ** rng.integers(-20, 20, 200_000)
    mant = rng.integers(0, 2 ** 7, 50_000).astype(np.uint32) << 16
    expo = rng.integers(1, 254, 50_000).astype(np.uint32) << 23
    sign = rng.integers(0, 2, 50_000).astype(np.uint32) << 31
    ties = (sign | expo | mant | 0x8000).view(np.float32).astype(np.float64)
    for arr in (x, ties, ties * (1 + 2.0 ** -40), ties * (1 - 2.0 ** -40),
                ties * (1 + 2.0 ** -30)):
        want = _bits(jnp.asarray(arr).astype(jnp.bfloat16))
        got = _bits(torch.from_numpy(arr).to(BF16))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["symdia", "dia"])
def test_operator_astype_bits_match_jax(fmt):
    jop, _, _ = cgt.banded_model(4096, k=8, kappa=100.0, fmt=fmt)
    top, _, _ = port.banded_model(4096, k=8, kappa=100.0, fmt=fmt,
                                  device="cpu")
    jb, tb = jop.astype(jnp.bfloat16), top.astype(BF16)
    assert tb.dtype == BF16 and tb.offsets == tuple(jop.offsets)
    np.testing.assert_array_equal(_bits(tb.data), _bits(jb.data))


# ---------------------------------------------------------------------------
# tests/test_bf16_storage.py's three properties, port and JAX side by side


@pytest.mark.parametrize("fmt", ["dia", "symdia"])
def test_bf16_storage_solves_to_perturbation_floor(fmt):
    kw = dict(max_iter=200, preconditioner="jacobi",
              probes=("error_A_norm",))
    jop, b, xt = cgt.banded_model(8192, k=8, kappa=100.0, fmt=fmt)
    top, tb, _ = port.banded_model(8192, k=8, kappa=100.0, fmt=fmt,
                                   device="cpu")
    out = port.run("hs_pcg", top.astype(BF16), tb, x_true=xt, device="cpu",
                   **kw)
    assert out["x"].dtype == torch.float32  # vectors stay f32
    rel = out["error_A_norm"] / out["error_A_norm"][0]
    best = np.nanmin(rel)
    # converges well past bf16's 2^-8 element precision (the fixed-dA
    # floor), nowhere near the f32 floor
    assert best < 5e-3, best
    out32 = port.run("hs_pcg", top.astype(torch.float32), tb, x_true=xt,
                     device="cpu", **kw)
    rel32 = out32["error_A_norm"] / out32["error_A_norm"][0]
    assert np.nanmin(rel32) < best / 100  # f32 storage goes much deeper
    # the JAX package on the same bf16 data: the same history to the floor
    jout = cgt.run("hs_pcg", jop.astype(jnp.bfloat16), b, x_true=xt, **kw)
    jrel = np.asarray(jout["error_A_norm"]) / np.asarray(
        jout["error_A_norm"])[0]
    np.testing.assert_allclose(rel[:HIST_ROWS], jrel[:HIST_ROWS],
                               rtol=HIST_RTOL, atol=ERROR_ATOL)
    np.testing.assert_allclose(best, np.nanmin(jrel), rtol=1e-3)


def test_bf16_storage_fused_step_matches_promoted_path():
    """The fused half-band step (the plain version here, the bf16 kernel on
    the card) on bf16 data against the promoted path: the same band widened
    to float32, as XLA promotes it; and against the JAX package's fused
    kernel (interpret mode) and XLA path on the same bf16 data."""
    top, tb, xt = port.banded_model(4096, k=4, kappa=100.0, fmt="symdia",
                                    device="cpu")
    kw = dict(max_iter=60, probes=("error_A_norm",), x_true=xt)
    bf = top.astype(BF16)
    wide = to.as_operator(bf, dtype=torch.float32, device="cpu")
    assert wide.dtype == torch.float32
    out = port.run("pipe_pr_cg", bf, tb, device="cpu", **kw)
    ref = port.run("pipe_pr_cg", wide, tb, device="cpu", **kw)
    a, r = out["error_A_norm"], ref["error_A_norm"]
    np.testing.assert_allclose(a[:8], r[:8], rtol=1e-3)
    assert 0.25 < np.nanmin(a) / np.nanmin(r) < 4.0
    # the promotion is exact: the same bits
    np.testing.assert_array_equal(a, r)
    jop, b, _ = cgt.banded_model(4096, k=4, kappa=100.0, fmt="symdia")
    jout = cgt.run("pipe_pr_cg", jop.astype(jnp.bfloat16), b, **kw)
    jrel = np.asarray(jout["error_A_norm"])
    np.testing.assert_allclose(a[:HIST_ROWS] / a[0],
                               jrel[:HIST_ROWS] / jrel[0],
                               rtol=HIST_RTOL, atol=ERROR_ATOL)


def test_bf16_standalone_spmvs_return_float32():
    """The standalone SpMVs take bf16 data with float32 vectors and return
    float32 (the JAX kernels' outputs take the vector dtype too)."""
    jop, _, _ = cgt.banded_model(4096, k=8, kappa=100.0, fmt="symdia")
    top, _, _ = port.banded_model(4096, k=8, kappa=100.0, fmt="symdia",
                                  device="cpu")
    v = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    bf = top.astype(BF16)
    y = tsd.sym_dia_spmv(bf.offsets, bf.data, torch.from_numpy(v))
    assert y.dtype == torch.float32
    want = top.astype(torch.float32).mv(torch.from_numpy(v)).numpy()
    assert np.abs(y.numpy() - want).max() / np.abs(want).max() < 1e-2
    jb = jop.astype(jnp.bfloat16)
    _close(y, jsd.sym_dia_spmv(jb.offsets, jb.data, jnp.asarray(v),
                               interpret=True))

    jopd, _, _ = cgt.banded_model(4096, k=8, kappa=100.0)
    topd, _, _ = port.banded_model(4096, k=8, kappa=100.0, fmt="dia",
                                   device="cpu")
    bfd, jbd = topd.astype(BF16), jopd.astype(jnp.bfloat16)
    yd = tsp.dia_spmv(bfd.offsets, bfd.data, torch.from_numpy(v))
    assert yd.dtype == torch.float32
    _close(yd, jsp.dia_spmv(jbd.offsets, jbd.data, jnp.asarray(v),
                            interpret=True))


# ---------------------------------------------------------------------------
# each band kernel's plain version against the JAX Pallas kernel


@pytest.mark.parametrize("n,k", [(4096, 8), (5000, 5)])
def test_sym_dia_spmv_matches_jax_kernel(n, k):
    offsets = tuple(range(k))
    jd, td = _bf16_pair(_band(offsets, n, seed=n + k))
    v, w = _vectors("vw", n, seed=1)
    y = tsd.sym_dia_spmv(offsets, td, torch.from_numpy(v))
    y2, z2 = tsd.sym_dia_spmv2(offsets, td, torch.from_numpy(v),
                               torch.from_numpy(w))
    jy = jsd.sym_dia_spmv(offsets, jd, jnp.asarray(v), interpret=True)
    jy2, jz2 = jsd.sym_dia_spmv2(offsets, jd, jnp.asarray(v), jnp.asarray(w),
                                 interpret=True)
    for got, want in ((y, jy), (y2, jy2), (z2, jz2)):
        _close(got, want)


def _with_recompute(entries):
    """``(entry, recompute)`` cases: both switches for the pipe entries."""
    return [(e, rc) for e in entries
            for rc in ((True, False) if "pipe" in e else (True,))]


SYM_CASES = _with_recompute(tsf.__all__)


@pytest.mark.parametrize("entry,recompute", SYM_CASES,
                         ids=[f"{e}-{rc}" for e, rc in SYM_CASES])
def test_sym_family_entry_matches_jax_kernel(entry, recompute):
    n, offsets = 4096, tuple(range(8))
    jd, td = _bf16_pair(_band(offsets, n, seed=11))
    vnames, snames = _signature(getattr(tsf, entry))
    vecs = _vectors(vnames, n, seed=len(vnames))
    sc = [A1 if s == "a1" else BETA for s in snames]
    kw = {"recompute": recompute} if "pipe" in entry else {}
    want = getattr(jsf, entry)(
        offsets, jd, *map(jnp.asarray, vecs),
        *[jnp.asarray(s, jnp.float32) for s in sc], tile=1024,
        interpret=True, **kw)
    got = getattr(tsf, entry)(
        offsets, td, *map(torch.from_numpy, vecs),
        *[torch.tensor(s) for s in sc], **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got[:-1], want[:-1])):
        _close(g, w, err_msg=f"output {i}")
    for g, w in zip(got[-1], want[-1]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("offsets", [tuple(range(-7, 8)), (-3, -1, 0, 2, 7)],
                         ids=["band", "nonsym"])
def test_dia_spmv_matches_jax_kernel(offsets):
    n = 4096
    h = max(abs(o) for o in offsets)
    jd, td = _bf16_pair(_band(offsets, n, seed=3))
    v, w = _vectors("vw", n, seed=4)
    vx, wx = _vectors("vw", n + 2 * h, seed=5)
    # a shard's band: interior rows, no zeros at its edges
    js, ts = _bf16_pair(np.random.default_rng(6).uniform(-1, 1, (len(offsets),
                                                                 n)))
    cases = [
        (tsp.dia_spmv(offsets, td, torch.from_numpy(v)),
         jsp.dia_spmv(offsets, jd, jnp.asarray(v), interpret=True)),
        (tsp.dia_spmv2(offsets, td, torch.from_numpy(v), torch.from_numpy(w)),
         jsp.dia_spmv2(offsets, jd, jnp.asarray(v), jnp.asarray(w),
                       interpret=True)),
        (tsp.dia_spmv_ext(offsets, ts, torch.from_numpy(vx)),
         jsp.dia_spmv_ext(offsets, js, jnp.asarray(vx), interpret=True)),
        (tsp.dia_spmv2_ext(offsets, ts, torch.from_numpy(vx),
                           torch.from_numpy(wx)),
         jsp.dia_spmv2_ext(offsets, js, jnp.asarray(vx), jnp.asarray(wx),
                           interpret=True)),
    ]
    for got, want in cases:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w_ in zip(got, want):
            _close(g, w_)


DIA_CASES = _with_recompute(
    ["fused_pipe_full_step", "fused_pipe_full_step_prec"]
    + [name for name in tff.__all__ if name != "supports_full_step"])


@pytest.mark.parametrize("entry,recompute", DIA_CASES,
                         ids=[f"{e}-{rc}" for e, rc in DIA_CASES])
def test_dia_family_entry_matches_jax_kernel(entry, recompute):
    jmod, tmod = (jfs, tfs) if "pipe" in entry else (jff, tff)
    n, offsets = 4096, tuple(range(-7, 8))
    jd, td = _bf16_pair(_band(offsets, n, seed=12))
    vnames, snames = _signature(getattr(tmod, entry))
    vecs = _vectors(vnames, n, seed=len(vnames) + 1)
    sc = [A1 if s == "a1" else BETA for s in snames]
    kw = {"recompute": recompute} if "pipe" in entry else {}
    want = getattr(jmod, entry)(
        offsets, jd, *map(jnp.asarray, vecs),
        *[jnp.asarray(s, jnp.float32) for s in sc], tile=2048,
        interpret=True, **kw)
    got = getattr(tmod, entry)(
        offsets, td, *map(torch.from_numpy, vecs),
        *[torch.tensor(s) for s in sc], **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got[:-1], want[:-1])):
        _close(g, w, err_msg=f"output {i}")
    for g, w in zip(got[-1], want[-1]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.fixture(scope="module")
def ell_pair():
    """A permuted 9-point grid as ELL in both packages, values in bf16 (the
    port's in its RCM order)."""
    a = grid9()
    jc, tc = both(a)
    jop = jo.from_coo(jc, fmt="ell", dtype=jnp.bfloat16)
    top = to.from_coo(tc, fmt="ell", dtype=BF16, device="cpu")
    return a, jop, top


def test_ell_product_matches_jax(ell_pair):
    """Row 12's plain version on bf16 values against the JAX package's
    ``EllOperator.mv`` / ``mv2`` (its XLA path, promoted to float32)."""
    a, jop, top = ell_pair
    assert top.dtype == BF16 and top.perm is not None
    np.testing.assert_array_equal(
        _bits(top.val), _bits(np.asarray(jop.val)))
    v, w = _vectors("vw", a.shape[0], seed=7)
    y = top.mv(torch.from_numpy(v))
    y2, z2 = top.mv2(torch.from_numpy(v), torch.from_numpy(w))
    jy = jop.mv(jnp.asarray(v))
    jy2, jz2 = jop.mv2(jnp.asarray(v), jnp.asarray(w))
    for got, want in ((y, jy), (y2, jy2), (z2, jz2)):
        _close(got, want)
    # the locality order gives the given order's bits
    given = tes.ell_spmv(top.val, top.idx, torch.from_numpy(v))
    np.testing.assert_array_equal(y.numpy(), given.numpy())


# ---------------------------------------------------------------------------
# whole solves against the JAX package


def _run_both(name, jop, top, b, max_iter, probes=("nu", "alpha")):
    kw = dict(max_iter=max_iter, probes=probes,
              preconditioner="jacobi" if name.endswith("pcg") else None)
    return (port.run(name, top, b, device="cpu", **kw),
            cgt.run(name, jop, b, **kw))


def _assert_parity(name, jop, top, b):
    got, want = _run_both(name, jop, top, b, OUTCOME_ITERS,
                          probes=("nu", "alpha", "residual_2_norm"))
    assert got["x"].dtype == torch.float32
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(got[p][:HIST_ROWS],
                                   np.asarray(want[p])[:HIST_ROWS],
                                   rtol=HIST_RTOL, err_msg=p)
    best = [np.log10(np.nanmin(r / r[0])) for r in (
        got["residual_2_norm"], np.asarray(want["residual_2_norm"]))]
    assert abs(best[0] - best[1]) <= OUTCOME_LOG10_TOL, best
    assert best[0] < -2.0  # it iterates


@pytest.fixture(scope="module")
def band_problems():
    """bf16 half-band and full-DIA operators in both packages: the model
    problem for the ``_cg`` names, for the ``_pcg`` names the scaled band
    with eps = 1e-2 (Jacobi leaves a condition number near 1e2; on the model
    problem it solves within a few iterations, and at eps = 1e-3 the gv and
    pipe_p names amplify the two packages' rounding differences past 1e-4
    by iteration 15)."""
    out = {}
    for fmt in ("symdia", "dia"):
        jop, b, _ = cgt.banded_model(2048, k=8, kappa=100.0, fmt=fmt)
        top, _, _ = port.banded_model(2048, k=8, kappa=100.0, fmt=fmt,
                                      device="cpu")
        out[fmt, "cg"] = (jop.astype(jnp.bfloat16), top.astype(BF16), b)
        offsets, data = scaled_band(eps=1e-2)
        top = operator_from_numpy(offsets, data, device="cpu")
        if fmt == "dia":
            offsets, data = top.todia_host()
            top = operator_from_numpy(offsets, data, kind="dia", device="cpu")
            jop = jo.DiaOperator(offsets, jnp.asarray(data))
        else:
            jop = JaxSymDia(offsets, jnp.asarray(data))
        b = top.todense() @ np.ones(top.n)
        out[fmt, "pcg"] = (jop.astype(jnp.bfloat16), top.astype(BF16), b)
    return out


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
@pytest.mark.parametrize("fmt", ["symdia", "dia"])
def test_variant_histories_on_bf16_bands(band_problems, fmt, name):
    jop, top, b = band_problems[fmt, "pcg" if name.endswith("pcg") else "cg"]
    assert top.dtype == BF16
    _assert_parity(name, jop, top, b)


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
def test_variant_histories_on_bf16_ell(ell_pair, name):
    a, jop, top = ell_pair
    _assert_parity(name, jop, top, a @ np.ones(a.shape[0]))


@pytest.fixture(scope="module")
def dense_and_block_banded():
    g = grid9()
    dense = g.toarray()
    lap = laplacian()
    jc, tc = both(lap)
    return {
        "dense": (jo.DenseOperator(jnp.asarray(dense)).astype(jnp.bfloat16),
                  to.as_operator(dense, dtype=BF16, device="cpu"),
                  g @ np.ones(g.shape[0])),
        "block_banded": (
            jo.from_coo(jc, fmt="block_banded", dtype=jnp.bfloat16),
            to.from_coo(tc, fmt="block_banded", dtype=BF16, device="cpu"),
            lap @ np.ones(lap.shape[0])),
    }


@pytest.mark.parametrize("name", ["pipe_pr_cg", "hs_pcg"])
@pytest.mark.parametrize("kind", ["dense", "block_banded"])
def test_variant_histories_on_bf16_dense_and_block_banded(
        dense_and_block_banded, kind, name):
    jop, top, b = dense_and_block_banded[kind]
    assert top.dtype == BF16
    _assert_parity(name, jop, top, b)


# ---------------------------------------------------------------------------
# the dense and block-banded operators on bf16 storage


def _random_spd_coo(n=512, density=0.01, seed=1, band=None):
    """A random symmetric n x n matrix plus 10 I; ``band``: only the
    entries within that distance of the diagonal (few diagonals, for the
    DIA formats)."""
    a = sp.random(n, n, density=density, random_state=seed).tocoo()
    if band is not None:
        keep = np.abs(a.row - a.col) <= band
        a = sp.coo_matrix((a.data[keep], (a.row[keep], a.col[keep])),
                          shape=(n, n))
    a = (a + a.T + 10.0 * sp.eye(n)).tocsr()
    return a, both(a)


def test_dense_operator_keeps_bf16_storage():
    a, (_, tc) = _random_spd_coo()
    op = to.from_coo(tc, fmt="dense", dtype=BF16, device="cpu")
    assert isinstance(op, to.DenseOperator) and op.a.dtype == BF16
    v = torch.from_numpy(_vectors("v", a.shape[0], seed=2)[0])
    y = op.mv(v)
    y2, z2 = op.mv2(v, 2.0 * v)
    want = op.a.float() @ v
    assert y.dtype == torch.float32 and op.a.dtype == BF16
    np.testing.assert_array_equal(y.numpy(), want.numpy())
    np.testing.assert_allclose(y2.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    np.testing.assert_allclose(z2.numpy(), 2.0 * want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    res = port.solve(op, a @ np.ones(a.shape[0]), variant="pipe_pr_cg",
                     rtol=1e-2, device="cpu")
    assert res.converged and res.x.dtype == torch.float32
    assert op.dtype == BF16


def test_block_banded_operator_keeps_bf16_storage():
    lap = laplacian()
    _, tc = both(lap)
    op = to.from_coo(tc, fmt="block_banded", dtype=BF16, device="cpu")
    assert isinstance(op, PermutedBlockBandedOperator)
    assert op.dtype == BF16 and op.inner.a_blk.dtype == BF16
    v = torch.from_numpy(_vectors("v", op.n, seed=3)[0])
    y = op.mv(v)
    y2, z2 = op.mv2(v, v)
    assert y.dtype == y2.dtype == torch.float32
    wide = PermutedBlockBandedOperator(op.inner.astype(torch.float32),
                                       op.perm)
    want = wide.mv(v)
    np.testing.assert_array_equal(y.numpy(), want.numpy())
    np.testing.assert_allclose(y2.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    np.testing.assert_array_equal(y2.numpy(), z2.numpy())
    res = port.solve(op, lap @ np.ones(op.n), variant="pipe_pr_cg",
                     rtol=1e-2, device="cpu")
    assert res.converged and res.x.dtype == torch.float32
    assert op.inner.a_blk.dtype == BF16


@pytest.mark.parametrize("fmt", ["auto", "dense", "dia", "symdia", "ell",
                                 "block_banded"])
def test_from_coo_bf16_solves_as_jax(fmt):
    """A random symmetric 512 x 512 matrix (1% dense, plus 10 I; for the
    DIA formats only its entries within 16 of the diagonal, as the JAX
    package compiles one shift per stored diagonal), stored in bf16 in
    each format: pipe-PR-CG to rtol 1e-2 in as many iterations as the JAX
    package takes (the auto route picks dense at n = 512)."""
    a, (jc, tc) = _random_spd_coo(
        band=16 if fmt in ("dia", "symdia") else None)
    b = a @ np.ones(a.shape[0])
    jop = jo.from_coo(jc, fmt=fmt, dtype=jnp.bfloat16)
    top = to.from_coo(tc, fmt=fmt, dtype=BF16, device="cpu")
    assert top.dtype == BF16
    if fmt == "auto":
        assert isinstance(top, to.DenseOperator)
    want = cgt.solve(jop, b, variant="pipe_pr_cg", rtol=1e-2)
    got = port.solve(top, b, variant="pipe_pr_cg", rtol=1e-2, device="cpu")
    assert got.converged and want.converged
    assert got.iterations == want.iterations
    assert got.x.dtype == torch.float32
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the CUDA wrappers' argument rules (no card: stand-ins for CUDA tensors)


def _fake(dtype, shape):
    return _FakeCudaTensor(is_cuda=True, dtype=dtype, shape=shape,
                           device=torch.device("cuda", 0))


def test_bf16_band_pairs_with_float32_vectors():
    offsets = tuple(range(8))
    data = _fake(BF16, (8, 4096))
    vec = _fake(torch.float32, (4096,))
    assert _kernels.check_band(offsets, data) == (4096, "bf16")
    assert _kernels.compute_dtype(BF16) == torch.float32
    assert tsd.check_kernel_args(offsets, data, (vec, vec), 2) == (
        4096, 7, "bf16")
    for entry, (_, _, _, nmv) in tsf._FAMILY_ENTRIES.items():
        assert tsd.check_kernel_args(
            offsets, data, (vec,), nmv, entry=entry,
            tile=_kernels.SYM_FAMILY_TILE) == (4096, 7, "bf16")
    # float32 and float64 data keep pairing with their own dtype
    for dt, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
        assert tsd.check_kernel_args(offsets, _fake(dt, (8, 4096)),
                                     (_fake(dt, (4096,)),), 1)[2] == sfx
    with pytest.raises(TypeError):
        tsd.check_kernel_args(offsets, _fake(torch.float32, (8, 4096)),
                              (_fake(torch.float64, (4096,)),), 1)


def test_bf16_vectors_and_float16_data_are_refused():
    offsets = tuple(range(8))
    with pytest.raises(TypeError, match="bfloat16"):
        tsd.check_kernel_args(offsets, _fake(BF16, (8, 4096)),
                              (_fake(BF16, (4096,)),), 1)
    with pytest.raises(TypeError, match="float16"):
        _kernels.check_band(offsets, _fake(torch.float16, (8, 4096)))
    with pytest.raises(TypeError, match="float16"):
        tsp._launch((-1, 0, 1), _fake(torch.float16, (3, 256)), (), False)
    # the vector phases take no band: bf16 vectors are refused there too
    x = _fake(BF16, (256,))
    x.ndim = 1
    with pytest.raises(TypeError, match="bfloat16"):
        tfs.fused_pipe_vector_phase(x, x, x, x, x, x, A1, BETA)


def test_ell_arrays_take_bf16_values():
    n, L = 1000, 7
    val = _FakeCudaTensor(is_cuda=True, dtype=BF16, shape=(n, L), ndim=2,
                          device=torch.device("cuda", 0))
    val.T = _FakeCudaTensor(is_contiguous=lambda: True)
    idx = _FakeCudaTensor(is_cuda=True, dtype=torch.int32, shape=(n, L),
                          device=torch.device("cuda", 0))
    idx.T = _FakeCudaTensor(is_contiguous=lambda: True)
    assert _kernels.check_ell(val, idx) == (n, L, "bf16")
    _kernels.check_vectors(val, (_fake(torch.float32, (n,)),), n)
    with pytest.raises(TypeError):
        _kernels.check_vectors(val, (_fake(BF16, (n,)),), n)
    val.dtype = torch.float16
    with pytest.raises(TypeError, match="float16"):
        _kernels.check_ell(val, idx)


@pytest.mark.parametrize("nvec", [1, 2])
def test_window_sizing_is_the_same_for_bf16_and_float32_data(nvec):
    """The half-band kernels stage float32 vector windows whatever the
    band's storage: the shared-memory check sizes them by the vectors'
    itemsize, so bf16 data hits the limit at the half-band float32 data
    does (sized by the band's 2 bytes, the windows would be undersized by
    half)."""
    n = 100_000
    vec = _fake(torch.float32, (n,))

    def fits(dtype, h):
        offsets = (0, 1, h)
        try:
            tsd.check_kernel_args(offsets, _fake(dtype, (3, n)),
                                  (vec,) * nvec, nvec)
        except ValueError:
            return False
        return True

    limit = max(h for h in range(1, n)
                if tsd.kernel_smem_bytes(h, nvec, 4) <= tsd.MAX_SMEM_BYTES)
    assert limit < n - 1
    for h in (limit - 1, limit, limit + 1):
        assert fits(BF16, h) == fits(torch.float32, h) == (h <= limit)
    assert tsd.kernel_smem_bytes(limit + 1, nvec, 2) <= tsd.MAX_SMEM_BYTES

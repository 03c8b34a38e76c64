"""Port parity: ELL solves in the operator's RCM basis.

An ``EllOperator`` in a locality order stores ``B = P A P^T``.  ``run``,
``solve``, ``time_variant`` and the mesh path's ``dist_run`` iterate on
``B`` itself (``ops/block_banded.py:solver_basis``): ``b``, ``x0`` and
``x_true`` are gathered into the basis once a solve, ``x`` and the vector
probe rows scattered back, and no product of the loop gathers in or
scatters out.  Held here on the CPU, in float64, on HPCG's operator of a
20^3 grid scaled on both sides by a random diagonal and permuted at random
(``from_coo(fmt="ell")`` keeps its RCM order):

* the change of basis is exact: every name of ``VARIANT_NAMES`` on the
  permuted operator gives ``x`` and every probe row of ``run`` on the
  explicit ``B`` (an ``EllOperator`` with no order, ``b[perm]``) bit for
  bit, once permuted back;
* parity with the JAX package's ``EllOperator`` in the given order: the
  Jacobi ``_pcg`` names and an object and a callable preconditioner of
  distinct diagonal entries (nu and alpha to rtol 1e-10 over 25
  iterations), ``solve`` (the same iterations, ``x``) and ``time_variant``;
* no gather inside the loop: ``_ell_gather_plain`` runs once for each
  vector moved into the basis, whatever the iteration count, and
  ``_ell_reordered_plain`` never; an object preconditioner is the one place
  the gather runs inside the loop, and a step with it reads nothing back
  (what a capture needs);
* a ``JacobiPreconditioner`` object in the original order has its
  diagonal moved into the basis once: it matches JAX, and no gather runs
  inside the loop;
* the mesh path: ``dist_run`` at 2 gloo ranks against the JAX package's
  ``dist_run`` on the given order, on a scattered pattern whose given order
  takes the all-gather and whose basis a planned index exchange, with no
  preconditioner, ``"jacobi"`` and a Jacobi object; at 1 rank (a group of
  its own, run meanwhile) a Jacobi object and a function holding a
  diagonal in the original order, which the one rank applies as a single
  device does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from functools import partial

import new_cg_variants_tpu as cgt
from new_cg_variants_tpu.harness import scaling as jhs
from new_cg_variants_tpu.matio.matrix_market import CooMatrix as JaxCoo
from new_cg_variants_tpu.ops import operators as jo
from new_cg_variants_tpu.parallel import dist_run as jax_dist_run
from new_cg_variants_tpu.parallel import make_mesh as jax_make_mesh
from new_cg_variants_tpu.solvers.precond import (
    JacobiPreconditioner as JaxJacobi,
)
import torch_dist_groups as groups_
import torch_dist_worker as worker
from test_torch_capture_reads import HostReads
import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.harness import scaling as ths
from new_cg_variants_tpu_torch.ops import ell_spmv as es
from new_cg_variants_tpu_torch.ops import operators as to
from new_cg_variants_tpu_torch.ops.block_banded import solver_basis
from new_cg_variants_tpu_torch.solvers import api as tapi
from new_cg_variants_tpu_torch.solvers.context import Context
from new_cg_variants_tpu_torch.solvers.precond import (
    FunctionPreconditioner,
    JacobiPreconditioner,
)

GRID = 20
ITERS = 25
HIST_RTOL = 1e-10
X_RTOL = 1e-8
PROBES = ("nu", "alpha", "save_x", "save_r", "error_A_norm")
PCG_NAMES = tuple(n for n in port.VARIANT_NAMES if n.endswith("_pcg"))
#: a scattered pattern of one stored neighbour a row: at 2 ranks the
#: planner takes the all-gather in the given order and a planned index
#: exchange on B (its RCM band is narrow)
MESH_PROBLEM = ("ell", 512, 2, None, 3)
MESH_ROWS = ITERS + 1
DEADLINE_S = 120


def coo_pair(a):
    c = sp.coo_matrix(a)
    row, col = c.row.astype(np.int64), c.col.astype(np.int64)
    return (JaxCoo(a.shape, row, col, c.data),
            port.CooMatrix(a.shape, row.copy(), col.copy(), c.data.copy()))


def hpcg27(grid=GRID, seed=0):
    """HPCG's operator on a grid^3 (the 27-point stencil, diagonal 26, -1
    to every neighbour) as ``D A D`` for a random diagonal ``D`` in [1, 10]
    (distinct diagonal entries), under a random symmetric permutation;
    scipy CSR.  At 20^3 (n = 8000) 25 iterations with Jacobi end near
    nu / nu_0 = 6e-10, where the gv and pipe_p recurrences still hold any
    two summation orders within 1e-11 of each other; at 16^3 they end near
    2e-11, and gv_pcg's orders part by 2e-10 there (the given order's as
    much as the basis's)."""
    rng = np.random.default_rng(seed)
    t = sp.diags([1.0, 1.0, 1.0], [-1, 0, 1], shape=(grid, grid))
    n = grid ** 3
    a = 27.0 * sp.eye(n) - sp.kron(sp.kron(t, t), t)
    d = sp.diags(np.sqrt(rng.uniform(1.0, 100.0, n)))
    p = rng.permutation(n)
    return (d @ a @ d).tocsr()[p][:, p].tocsr()


@pytest.fixture(scope="module")
def ell_pair():
    """``(a, b, x_true, JAX operator in the given order, the port's in its
    RCM order)``."""
    a = hpcg27()
    jc, tc = coo_pair(a)
    top = to.from_coo(tc, fmt="ell", device="cpu")
    assert top.perm is not None
    jop = jo.from_coo(jc, fmt="ell", dtype=jnp.float64)
    n = a.shape[0]
    x_true = np.ones(n) / np.sqrt(n)
    return a, a @ x_true, x_true, jop, top


def explicit_b(top):
    """``B`` as an operator of its own: a copy of the stored rows, no
    order."""
    return to.EllOperator(top.val_t.T.clone(), top.idx_t.T.clone(),
                          top.nnz)


def scattered(rows, perm):
    """Rows of ``B``'s numbering (the first axis) in the original one."""
    out = np.empty_like(rows)
    out[perm] = rows
    return out


def pcg_spec(name):
    return "jacobi" if name.endswith("_pcg") else None


def test_solver_basis_of_an_ell_operator(ell_pair):
    a, _, _, _, top = ell_pair
    inner, to_basis, from_basis = solver_basis(top)
    assert inner.perm is None and inner.n == top.n
    assert inner.val_t is top.val_t and inner.idx_t is top.idx_t
    perm = top.perm.long()
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.standard_normal(top.n))
    assert torch.equal(to_basis(v), v[perm])
    assert torch.equal(from_basis(to_basis(v)), v)
    two = torch.from_numpy(rng.standard_normal((top.n, 3)))
    assert torch.equal(to_basis(two), two[perm])
    assert torch.equal(from_basis(to_basis(two)), two)
    # B's product of v[perm] is the given order's product of v, permuted:
    # the same terms in the same slot order
    assert torch.equal(inner.mv(to_basis(v)), to_basis(top.mv(v)))
    w = torch.from_numpy(rng.standard_normal(top.n))
    for got, want in zip(inner.mv2(to_basis(v), to_basis(w)),
                         top.mv2(v, w)):
        assert torch.equal(got, to_basis(want))
    np.testing.assert_array_equal(inner.diagonal().numpy(),
                                  a.diagonal()[perm.numpy()])
    given = to.EllOperator(top.val, top.idx, top.nnz)
    same, ident, _ = solver_basis(given)
    assert same is given and ident(v) is v


def test_the_gather_leaves_no_cuda_tensor_to_the_plain_version(ell_pair):
    *_, top = ell_pair
    v = torch.empty(top.n, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        es.gather_rows(top.perm, v)


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
def test_the_change_of_basis_is_exact(ell_pair, name):
    _, b, x_true, _, top = ell_pair
    perm = top.perm.numpy()
    kw = dict(max_iter=ITERS + 1, probes=PROBES, dtype=np.float64,
              preconditioner=pcg_spec(name), device="cpu")
    got = port.run(name, top, b, x_true=x_true, **kw)
    want = port.run(name, explicit_b(top), b[perm], x_true=x_true[perm],
                    **kw)
    assert torch.equal(got["x"], torch.from_numpy(
        scattered(want["x"].numpy(), perm)))
    for p in PROBES:
        w = want[p]
        if w.ndim == 2:
            w = scattered(w.T, perm).T
        assert got[p].tobytes() == w.tobytes(), p


def jax_run(name, jop, b, **kw):
    return cgt.run(name, jop, b, max_iter=ITERS + 1, probes=("nu", "alpha"),
                   dtype=np.float64, **kw)


def port_run(name, top, b, **kw):
    return port.run(name, top, b, max_iter=ITERS + 1, probes=("nu", "alpha"),
                    dtype=np.float64, device="cpu", **kw)


def assert_histories(got, want):
    for p in ("nu", "alpha"):
        np.testing.assert_allclose(got[p], want[p], rtol=HIST_RTOL)
    assert got["nu"][-1] < 1e-3 * got["nu"][0]


@pytest.mark.parametrize("name", PCG_NAMES)
def test_jacobi_names_match_jax_in_the_given_order(ell_pair, name):
    _, b, _, jop, top = ell_pair
    assert_histories(port_run(name, top, b, preconditioner="jacobi"),
                     jax_run(name, jop, b, preconditioner="jacobi"))


class Diagonal:
    """``v -> inv * v`` (as a Jacobi preconditioner applies it) for a
    diagonal ``inv`` in the original order; records the vectors it was
    handed."""

    def __init__(self, inv):
        self.inv, self.seen = inv, []

    def apply(self, v):
        self.seen.append(v)
        return self.inv * v


@pytest.mark.parametrize("kind", ["object", "callable"])
@pytest.mark.parametrize("name", ["hs_pcg", "cg_pcg", "pipe_pr_pcg"])
def test_a_preconditioner_sees_the_original_order(ell_pair, name, kind):
    """Distinct diagonal entries in the original order: applied in the
    basis without the wrapper, they would scale the wrong rows."""
    a, b, _, jop, top = ell_pair
    inv = 1.0 / (a.diagonal()
                 * np.random.default_rng(5).uniform(0.5, 2.0, a.shape[0]))
    assert len(np.unique(inv)) == len(inv)
    mine = Diagonal(torch.from_numpy(inv))
    jinv = jnp.asarray(inv)
    if kind == "object":
        spec, jspec = mine, JaxJacobi(jinv)
    else:
        spec, jspec = mine.apply, lambda v: jinv * v
    assert_histories(port_run(name, top, b, preconditioner=spec),
                     jax_run(name, jop, b, preconditioner=jspec))
    # the first residual it sees is b itself, in the original order
    assert torch.equal(mine.seen[0], torch.from_numpy(b))


def distinct_inverse_diagonal(a, seed=5):
    """``1 / diag(a)``, each entry scaled by its own factor in [0.5, 2]:
    applied to the wrong rows it would give another solve."""
    inv = 1.0 / (a.diagonal()
                 * np.random.default_rng(seed).uniform(0.5, 2.0, a.shape[0]))
    assert len(np.unique(inv)) == len(inv)
    return inv


@pytest.mark.parametrize("name", ["hs_pcg", "cg_pcg", "pipe_pr_pcg"])
def test_a_jacobi_object_is_moved_into_the_basis(ell_pair, name):
    """A ``JacobiPreconditioner`` holds its diagonal in the original order
    (``convert.preconditioner_from_numpy`` makes one): the solve gathers
    it into the basis once and applies it there, as JAX applies it in the
    given order."""
    a, b, _, jop, top = ell_pair
    inv = distinct_inverse_diagonal(a)
    assert_histories(
        port_run(name, top, b,
                 preconditioner=JacobiPreconditioner(torch.from_numpy(inv))),
        jax_run(name, jop, b, preconditioner=JaxJacobi(jnp.asarray(inv))))


def test_a_spec_is_ignored_by_a_name_without_a_preconditioner(ell_pair):
    """As on every other operator, a name that is not ``_pcg`` ignores its
    preconditioner spec, whatever it is."""
    _, b, _, _, top = ell_pair
    got = port_run("pipe_pr_cg", top, b, preconditioner=42)
    want = port_run("pipe_pr_cg", top, b)
    assert torch.equal(got["x"], want["x"])
    assert got["nu"].tobytes() == want["nu"].tobytes()


@pytest.mark.parametrize("variant, spec", [("pipe_pr_cg", None),
                                           ("hs_pcg", "jacobi")])
def test_solve_matches_jax_in_the_given_order(ell_pair, variant, spec):
    _, b, _, jop, top = ell_pair
    kw = dict(variant=variant, rtol=1e-8, preconditioner=spec,
              dtype=np.float64)
    got = port.solve(top, b, device="cpu", **kw)
    want = cgt.solve(jop, b, **kw)
    assert got.converged and want.converged
    assert got.iterations == want.iterations
    x = np.asarray(want.x)
    np.testing.assert_allclose(got.x.numpy(), x, rtol=X_RTOL, atol=1e-10)


def test_time_variant_matches_jax_in_the_given_order(ell_pair):
    _, b, x_true, jop, top = ell_pair
    kw = dict(x_true=x_true, max_iter=ITERS, trials=1)
    got = ths.time_variant("pipe_pr_cg", top, b, device="cpu", **kw)
    want = jhs.time_variant("pipe_pr_cg", jop, b, dtype=jnp.float64, **kw)
    assert got.n == want.n == top.n
    np.testing.assert_allclose(got.error, want.error, rtol=1e-8)


@pytest.fixture
def gathers(monkeypatch):
    """Calls of the plain gather in and of the plain product in a locality
    order, counted."""
    calls = {"_ell_gather_plain": 0, "_ell_reordered_plain": 0}
    for name in calls:
        fn = getattr(es, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(es, name, counted)
    return calls


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
def test_no_gather_inside_the_loop(ell_pair, gathers, name):
    """b and x0 (and x_true, with an error probe) are gathered once a
    solve, whatever the iteration count; no product gathers."""
    _, b, x_true, _, top = ell_pair
    for iters, probes, moved in ((3, ("nu",), 2), (ITERS, ("nu",), 2),
                                 (ITERS, ("error_A_norm",), 3)):
        gathers.update(dict.fromkeys(gathers, 0))
        port.run(name, top, b, max_iter=iters, probes=probes,
                 x_true=x_true, preconditioner=pcg_spec(name),
                 dtype=np.float64, device="cpu")
        assert gathers == {"_ell_gather_plain": moved,
                           "_ell_reordered_plain": 0}, (iters, probes)
    gathers.update(dict.fromkeys(gathers, 0))
    port.solve(top, b, variant=name, max_iter=ITERS, norm_type="none",
               preconditioner=pcg_spec(name), dtype=np.float64,
               device="cpu")
    assert gathers == {"_ell_gather_plain": 2, "_ell_reordered_plain": 0}


def test_an_object_preconditioner_is_the_one_gather_in_the_loop(
        ell_pair, gathers):
    a, b, _, _, top = ell_pair
    spec = Diagonal(torch.from_numpy(1.0 / a.diagonal()))
    counts = []
    for iters in (5, 10):
        gathers.update(dict.fromkeys(gathers, 0))
        spec.seen.clear()
        port.run("hs_pcg", top, b, max_iter=iters, probes=("nu",),
                 preconditioner=spec, dtype=np.float64, device="cpu")
        assert gathers["_ell_reordered_plain"] == 0
        # b and x0, then one gather for each application
        assert gathers["_ell_gather_plain"] == 2 + len(spec.seen)
        counts.append(len(spec.seen))
    assert counts[1] > counts[0]


@pytest.mark.parametrize("entry", ["run", "solve", "time_variant"])
def test_a_jacobi_object_gathers_nothing_inside_the_loop(ell_pair, gathers,
                                                         entry):
    """b, x0 and the diagonal once a solve, at 3 steps as at 25: no gather
    inside the loop."""
    a, b, x_true, _, top = ell_pair
    spec = JacobiPreconditioner(torch.from_numpy(1.0 / a.diagonal()))
    for iters in (3, ITERS):
        gathers.update(dict.fromkeys(gathers, 0))
        if entry == "run":
            port.run("pipe_pr_pcg", top, b, max_iter=iters, probes=("nu",),
                     preconditioner=spec, dtype=np.float64, device="cpu")
        elif entry == "solve":
            port.solve(top, b, variant="pipe_pr_pcg", max_iter=iters,
                       norm_type="none", preconditioner=spec,
                       dtype=np.float64, device="cpu")
        else:
            ths.time_variant("pipe_pr_pcg", top, b, x_true=x_true,
                             max_iter=iters, trials=1, preconditioner=spec,
                             device="cpu")
        assert gathers == {"_ell_gather_plain": 3,
                           "_ell_reordered_plain": 0}, iters


@pytest.mark.parametrize("name", ["hs_pcg", "pipe_pr_pcg", "gv_pcg"])
def test_a_step_in_the_basis_reads_nothing_back(ell_pair, name):
    """What a capture needs (``test_torch_capture_reads.py``): a step on
    ``B`` with an object preconditioner in the original order (its scatter
    out and gather in) reads no value back and makes no tensor from host
    data."""
    a, b, _, _, top = ell_pair
    op, to_basis, _, init_fn, step_fn, prec = tapi.resolve(
        name, top, Diagonal(torch.from_numpy(1.0 / a.diagonal())))
    ctx = Context(op, prec)
    bb = to_basis(torch.from_numpy(b))
    state = init_fn(ctx, bb, torch.zeros_like(bb))
    with HostReads() as mode:
        step_fn(ctx, state)
    assert mode.reads == []


def mesh_inverse_diagonal():
    """The mesh problem's matrix and a distinct inverse diagonal of it in
    the original order."""
    a = worker.ell_matrix(*MESH_PROBLEM[1:])
    return a, distinct_inverse_diagonal(a, seed=7)


#: (world, name, preconditioner kind) of each dist_run held against JAX's
MESH_RUNS = ((2, "pipe_pr_cg", None), (2, "hs_pcg", "jacobi"),
             (2, "hs_pcg", "object"), (1, "hs_pcg", "object"),
             (1, "hs_pcg", "function"))
#: their test ids: the name alone for no preconditioner or "jacobi" at 2
#: ranks
MESH_IDS = [name if world == 2 and kind in (None, "jacobi")
            else f"{name}-{kind}-{world}" for world, name, kind in MESH_RUNS]


def mesh_specs(inv):
    """``{kind: (the port's spec, JAX's spec)}``: a Jacobi object and a
    function of a diagonal in the original order (the port's picklable, so
    that a spawned rank can take it)."""
    t, j = torch.from_numpy(inv), jnp.asarray(inv)
    return {None: (None, None), "jacobi": ("jacobi", "jacobi"),
            "object": (JacobiPreconditioner(t), JaxJacobi(j)),
            "function": (FunctionPreconditioner(partial(torch.mul, t)),
                         lambda v: j * v)}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """A gloo group of 2 ranks: ``dist_run`` of pipe_pr_cg, hs_pcg with
    Jacobi and with a Jacobi object on the scattered pattern, the
    collectives of three pipe_pr_cg steps, and the route the row context
    takes when it is handed the permuted operator itself; a world of one
    meanwhile (a Jacobi object, a function of a diagonal); JAX's
    ``dist_run`` on the given order at the same mesh sizes."""
    tmp = tmp_path_factory.mktemp("ell_basis")
    a, inv = mesh_inverse_diagonal()
    specs = mesh_specs(inv)
    cases = {1: [], 2: []}
    for world, name, kind in MESH_RUNS:
        cases[world].append(dict(
            key=("run", name, kind), kind="run", fmt="ell", variant=name,
            problem=MESH_PROBLEM,
            kw=dict(max_iter=MESH_ROWS, preconditioner=specs[kind][0])))
    cases[2].append(dict(key=("counts",), kind="counts", fmt="ell",
                         variant="pipe_pr_cg", problem=MESH_PROBLEM, kw={},
                         steps=3))
    cases[2].append(dict(key=("mode",), kind="mode", fmt="ell",
                         problem=MESH_PROBLEM, kw={}))
    groups = {w: groups_.start(w, tmp, c) for w, c in cases.items()}
    try:
        jop = jo.from_coo(coo_pair(a)[0], fmt="ell", dtype=jnp.float64)
        b = a @ (np.ones(a.shape[0]) / np.sqrt(a.shape[0]))
        jax_out = {(world, name, kind): jax_dist_run(
            name, jop, b, mesh=jax_make_mesh(world), max_iter=MESH_ROWS,
            dtype=np.float64, preconditioner=specs[kind][1])
            for world, name, kind in MESH_RUNS}
        results = groups_.join(groups, DEADLINE_S)
    finally:
        groups_.kill(groups)
    return results, jax_out


@pytest.mark.parametrize("world, name, kind", MESH_RUNS, ids=MESH_IDS)
def test_dist_run_in_the_basis_matches_jax_in_the_given_order(
        mesh_runs, world, name, kind):
    results, jax_out = mesh_runs
    got = groups_.result(results, world, ("run", name, kind))
    want = jax_out[(world, name, kind)]
    h, wh = got["updated_residual_2_norm"], np.asarray(
        want["updated_residual_2_norm"])
    assert h.shape == wh.shape == (MESH_ROWS,)
    np.testing.assert_allclose(h, wh, rtol=HIST_RTOL)
    assert h[-1] < 0.1 * h[0]
    x = np.asarray(want["x"])
    np.testing.assert_allclose(got["x"], x, rtol=0.0,
                               atol=X_RTOL * np.abs(x).max())


def test_dist_run_takes_the_basis_route(mesh_runs):
    """In the basis the planner finds an index exchange with one hop; the
    permuted operator handed to the row context itself keeps the
    all-gather of its locality order."""
    results, _ = mesh_runs
    steps = groups_.result(results, 2, ("counts",))
    assert len(steps) == 3
    for step in steps:
        assert (step["index_exchange"], step["all_gather"],
                step["all_reduce"]) == (1, 0, 1), step
    mode = groups_.result(results, 2, ("mode",))
    assert mode == {"type": "EllRowShardContext", "shifts": None}

"""Port parity: the family entry points on half-band storage against JAX.

Each entry point of the port's ``ops/sym_fused.py`` (all served by the family
kernel, ``csrc/sym_family.cu``) takes its plain PyTorch version on CPU
tensors; the CUDA kernel is held against that same version on the card
by ``chip_smoke.py``.  Here each is compared in float64, on one random state
over an O(1) random band at two band widths, with

* the JAX package's ``fused_sym_*`` function (its Pallas kernel in interpret
  mode, tile 256 over n = 1024: four tiles, ``2h <= tile``), and
* the JAX package's generic body: the same entry's update program, the
  operator's ``mv`` and the finish, composed outside any kernel.

The mirror sums run in another order than the JAX kernel's roll-and-spill
decomposition, so agreement is to rtol 1e-12 of each vector's largest entry
(and of sum |a_i b_i| for a dot), not bitwise.
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from new_cg_variants_tpu.ops import fused_family as jff
from new_cg_variants_tpu.ops import sym_fused as jsf
from new_cg_variants_tpu.ops.sym_dia import SymDiaOperator as JaxSymDia
from new_cg_variants_tpu_torch.ops import sym_dia as tsd
from new_cg_variants_tpu_torch.ops import sym_fused as tsf
from new_cg_variants_tpu_torch.ops._kernels import KERNEL_TILE, SYM_FAMILY_TILE

RTOL = 1e-12
N, TILE = 1024, 256
A1, BETA = 0.37, 0.61
IDENT = None

#: entry -> (vectors, scalars, Jacobi twin, JAX update, JAX finish, SpMVs,
#: return order as indices into JAX's "update outs + products + finish
#: extras" sequence (None: already in return order), keyword arguments)
ENTRIES = {
    "pipe_full_step": (6, (A1, BETA), False, jsf._pipe_update,
                       jsf._pipe_finish, 2, (0, 1, 5, 2, 3, 4),
                       {"recompute": True}),
    "pipe_full_step-norec": (6, (A1, BETA), False, jsf._pipe_update_norec,
                             jsf._pipe_finish_norec, 1, IDENT,
                             {"recompute": False}),
    "hs_matvec_phase": (2, (BETA,), False, jff._hs_update, jff._hs_finish,
                        1, IDENT, {}),
    "pr_full_step": (4, (A1, BETA), False, jff._pr_update, jff._pr_finish,
                     1, IDENT, {}),
    "cgcg_matvec_phase": (4, (A1,), False, jff._cgcg_update,
                          jff._cgcg_finish, 1, IDENT, {}),
    "gv_matvec_phase": (6, (A1,), False, jff._gv_update, jff._gv_finish,
                        1, IDENT, {}),
    "pr_full_step_prec": (7, (A1, BETA), True, jff._pr_prec_update,
                          jff._pr_prec_finish, 1, IDENT, {}),
    "cgcg_matvec_phase_prec": (5, (A1,), True, jff._cgcg_prec_update,
                               jff._cgcg_prec_finish, 1, IDENT, {}),
    "gv_matvec_phase_prec": (9, (A1,), True, jff._gv_prec_update,
                             jff._gv_prec_finish, 1, IDENT, {}),
    "pipe_full_step_prec": (11, (A1, BETA), True, jsf._pipe_prec_update,
                            jsf._pipe_prec_finish, 2,
                            (0, 1, 7, 2, 3, 6, 4, 5, 9, 8),
                            {"recompute": True}),
    "pipe_full_step_prec-norec": (11, (A1, BETA), True,
                                  jsf._pipe_prec_update_norec,
                                  jsf._pipe_prec_finish_norec, 1,
                                  (0, 1, 2, 4, 5, 8, 6, 7, 3, 9),
                                  {"recompute": False}),
}


def _functions(entry):
    name = "fused_sym_" + entry.split("-")[0]
    return getattr(jsf, name), getattr(tsf, name)


@pytest.fixture(scope="module", params=[8, 32], ids=["k8", "k32"])
def band(request):
    k = request.param
    rng = np.random.default_rng(100 + k)
    offsets = tuple(range(k))
    data = rng.uniform(-1.0, 1.0, (k, N))
    for d, off in enumerate(offsets):
        data[d, N - off:] = 0.0
    return offsets, data


def _inputs(entry, k):
    nvec, scalars, prec = ENTRIES[entry][:3]
    rng = np.random.default_rng(len(entry) + k)
    vecs = [rng.standard_normal(N) for _ in range(nvec)]
    if prec:
        vecs[0] = rng.uniform(0.5, 2.0, N)  # inv_diag
    return vecs, scalars


def _port(entry, band):
    offsets, data = band
    vecs, scalars = _inputs(entry, len(offsets))
    fn = _functions(entry)[1]
    out = fn(offsets, torch.from_numpy(data),
             *[torch.from_numpy(v) for v in vecs],
             *[torch.tensor(s, dtype=torch.float64) for s in scalars],
             **ENTRIES[entry][7])
    return [t.numpy() for t in out[:-1]], [float(d) for d in out[-1]]


def _close(got, want, dot_scales):
    gv, gd = got
    wv, wd = want
    assert len(gv) == len(wv) and len(gd) == len(wd) == len(dot_scales)
    for i, (g, w) in enumerate(zip(gv, wv)):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(),
                                   err_msg=f"vector output {i}")
    for i, (g, w, sc) in enumerate(zip(gd, wd, dot_scales)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * sc,
                                   err_msg=f"dot {i}")


def _jax_generic(entry, band):
    """The entry composed from the JAX package's update program, ``mv`` and
    finish; also the scale sum |a_i b_i| of each dot."""
    offsets, data = band
    _, _, _, update, finish, n_mv, order, _ = ENTRIES[entry]
    vecs, scalars = _inputs(entry, len(offsets))
    jop = JaxSymDia(offsets, jnp.asarray(data))
    jv = tuple(jnp.asarray(v) for v in vecs)
    outs, mv_in = update(scalars, *jv)
    if n_mv == 1 and not isinstance(mv_in, tuple):
        acc = jop.mv(mv_in)
        extra, prods = finish(scalars, outs, acc, jv)
        accs = (acc,)
    else:
        accs = tuple(jop.mv(m) for m in mv_in)
        extra, prods = finish(scalars, outs, accs, jv)
    seq = [np.asarray(a) for a in tuple(outs) + accs + tuple(extra)]
    if order is not None:
        seq = [seq[i] for i in order]
    dots = [float(jnp.sum(p)) for p in prods]
    scales = [float(jnp.sum(jnp.abs(p))) for p in prods]
    return (seq, dots), scales


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_matches_jax_kernel_and_generic_body(band, entry):
    offsets, data = band
    vecs, scalars = _inputs(entry, len(offsets))
    jfn = _functions(entry)[0]
    jout = jfn(offsets, jnp.asarray(data), *[jnp.asarray(v) for v in vecs],
               *[jnp.asarray(s) for s in scalars], tile=TILE, interpret=True,
               **ENTRIES[entry][7])
    kernel = ([np.asarray(a) for a in jout[:-1]],
              [float(d) for d in jout[-1]])
    generic, scales = _jax_generic(entry, band)
    got = _port(entry, band)
    _close(got, kernel, scales)
    _close(got, generic, scales)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_outputs_are_new_tensors_and_inputs_untouched(entry):
    k = 8
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.uniform(-1.0, 1.0, (k, 300)))
    nvec, scalars = ENTRIES[entry][:2]
    ins = [torch.from_numpy(rng.standard_normal(300)) for _ in range(nvec)]
    before = [t.clone() for t in ins]
    zero = [torch.tensor(0.0, dtype=torch.float64) for _ in scalars]
    out = _functions(entry)[1](tuple(range(k)), data, *ins, *zero,
                               **ENTRIES[entry][7])
    for t, b in zip(ins, before):
        assert torch.equal(t, b)
    # with zero scalars x2 = x, r2 = r, ... in value, but never the same
    # storage: a neighbour block on the card still reads the old vectors
    assert not ({t.data_ptr() for t in ins}
                & {t.data_ptr() for t in out[:-1]})


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_cpu_path_counts_no_launch_and_mixed_devices_raise(entry):
    k = 4
    fn = _functions(entry)[1]
    nvec, scalars = ENTRIES[entry][:2]
    data = torch.ones((k, 64), dtype=torch.float64)
    vecs = [torch.ones(64, dtype=torch.float64) for _ in range(nvec)]
    before = fn.launches
    fn(tuple(range(k)), data, *vecs, *scalars, **ENTRIES[entry][7])
    assert fn.launches == before
    vecs[-1] = torch.empty(64, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="vectors on"):
        fn(tuple(range(k)), data, *vecs, *scalars, **ENTRIES[entry][7])


def test_every_wrapper_has_a_kernel_entry_and_a_counter():
    names = {fn.__name__ for fn in tsf.FAMILY_WRAPPERS}
    assert names == {e.split("/")[0] for e in tsf._FAMILY_ENTRIES}
    assert sorted(v[0] for v in tsf._FAMILY_ENTRIES.values()) == list(range(11))
    assert names == set(tsf.__all__)
    for fn in tsf.FAMILY_WRAPPERS:
        assert isinstance(fn.launches, int)
    # vector outputs and dots of each entry, as the JAX functions return them
    for entry, (_, nout, ndots, nmv) in tsf._FAMILY_ENTRIES.items():
        key = entry[len("fused_sym_"):].replace("/no recompute", "-norec")
        got = _port(key, (tuple(range(4)),
                          np.ones((4, N)) * np.array([[4.0], [1], [1], [1]])))
        assert (len(got[0]), len(got[1])) == (nout, ndots), entry
        assert nmv == ENTRIES[key][5], entry


class _FakeCudaTensor(types.SimpleNamespace):
    """Just enough of a CUDA tensor for ``check_kernel_args``'s size check."""

    def is_contiguous(self):
        return True

    def element_size(self):
        return self.dtype.itemsize


def _fake_band(offsets, dtype=torch.float64, n=4096):
    return _FakeCudaTensor(is_cuda=True, dtype=dtype,
                           shape=(len(offsets), n),
                           device=torch.device("cuda", 0))


def test_shared_memory_limit_error_names_the_entry_point():
    # two windows of a 2-SpMV entry over a half-band of 8000: > 227 KB in
    # float64 (the band itself is read from device memory)
    offsets = (0, 1, 8000)
    data = _fake_band(offsets)
    need = tsd.kernel_smem_bytes(8000, 2, 8)
    assert need > tsd.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="fused_sym_pipe_full_step_prec.*"
                                         f"{need} bytes of shared memory"):
        tsd.check_kernel_args(offsets, data, (), 2,
                              entry="fused_sym_pipe_full_step_prec")
    # a band that fits passes the same check
    ok = _FakeCudaTensor(is_cuda=True, dtype=torch.float64, shape=(32, 4096),
                         device=torch.device("cuda", 0))
    assert tsd.check_kernel_args(tuple(range(32)), ok, (), 2) == (
        4096, 31, "f64")


@pytest.mark.parametrize("ndiag", [200, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wide_band_fits_the_kernels(ndiag, dtype):
    """A band of up to MAX_DIAGS diagonals passes the check of every entry:
    only its vector windows are staged in shared memory, the band is not
    (a staged band of 200 f64 diagonals would need ~600 KB a block)."""
    offsets = tuple(range(ndiag))
    sfx = {torch.float64: "f64", torch.float32: "f32"}[dtype]
    assert tsd.check_kernel_args(offsets, _fake_band(offsets, dtype),
                                 (), 2) == (4096, ndiag - 1, sfx)
    for entry, (_, _, _, nmv) in tsf._FAMILY_ENTRIES.items():
        assert tsd.check_kernel_args(
            offsets, _fake_band(offsets, dtype), (), nmv, entry=entry,
            tile=SYM_FAMILY_TILE) == (4096, ndiag - 1, sfx)


@pytest.mark.parametrize("h, fits", [(31, True), (127, True), (6900, True),
                                     (7100, False)])
def test_pipe_footprint_is_independent_of_the_band_width(h, fits):
    """The pipe entry's footprint depends on the half-band h, not on how
    many diagonals are stored: two stored diagonals or h + 1 (up to
    MAX_DIAGS) give the same verdict and the same bytes."""
    entry = "fused_sym_pipe_full_step"
    nmv = tsf._FAMILY_ENTRIES[entry][3]
    need = tsd.kernel_smem_bytes(h, nmv, 8, SYM_FAMILY_TILE)
    assert (need <= tsd.MAX_SMEM_BYTES) == fits
    for offsets in ((0, h), tuple(range(min(h, 255))) + (h,)):
        data = _fake_band(offsets)
        if fits:
            assert tsd.check_kernel_args(offsets, data, (), nmv, entry=entry,
                                         tile=SYM_FAMILY_TILE)[1] == h
        else:
            with pytest.raises(ValueError, match=f"{entry}: .* {need} bytes"):
                tsd.check_kernel_args(offsets, data, (), nmv, entry=entry,
                                      tile=SYM_FAMILY_TILE)


def _source_constant(name, source):
    text = (Path(tsf.__file__).parent.parent / "csrc" / source).read_text()
    (value,) = re.findall(rf"constexpr int {name} = (\d+);", text)
    return int(value)


@pytest.mark.parametrize("n", [1, 100, 256, 257, 511, 512, 513, 4099,
                               655_360])
def test_partials_follow_the_family_kernel_tile(n):
    """The wrapper's tile and partials are the kernel's: blocks of kFamilyRows
    * kTile rows, each writing one partial per kTile rows that start before
    n, in block order."""
    tile = _source_constant("kTile", "sym_common.cuh")
    rows = _source_constant("kFamilyRows", "sym_family.cu")
    assert (tile, rows * tile) == (KERNEL_TILE, SYM_FAMILY_TILE)
    written = [b * rows + r for b in range(-(-n // (rows * tile)))
               for r in range(rows) if b * rows * tile + r * tile < n]
    assert written == list(range(len(written)))
    assert tsf.partials_shape(n, 4) == (len(written), 4)

"""No host read inside a step: what makes a step capturable.

A captured CUDA graph (``solvers/graphs.py``) replays a step's kernels with
the host out of the loop; a step that read a value back (``.item()``,
``float(t)``, a branch on a tensor), made a tensor from host data (a copy
from the host, which a capture refuses) or produced a shape that depends on
the data would fail to capture or freeze its answer into every replay.

:class:`HostReads` is a dispatch mode that records each such operation:
values read back (``aten._local_scalar_dense`` and every operation PyTorch
tags ``data_dependent_output``), tensors made from host data
(``aten.lift_fresh``), copies from a device to the host, and shapes that
depend on the data (operations tagged ``dynamic_output_shape``; an index
with integer tensors has a static shape and is not one).  It wraps one step
and one chunk of probe rows (every probe, the progress value and the
tolerance loop's norm) of every name on every operator kind (half-band,
full DIA, dense, ELL, stencil, block-banded), in float32, float64, bf16
storage, f32x2 and with ``compensated=True``, on the CPU (the plain
versions of the kernels), at n = 256: zero reads expected.  The card's
wrappers are held by capture itself in ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.ops.doublefloat import collapse
from new_cg_variants_tpu_torch.ops.operators import coo_from_scipy
from new_cg_variants_tpu_torch.probes.probes import PROBES
from new_cg_variants_tpu_torch.solvers import api as tapi
from new_cg_variants_tpu_torch.solvers import graphs

N = 256
K = 4
KINDS = ("symdia", "dia", "dense", "ell", "stencil", "block_banded")
MODES = ("float32", "float64", "bf16", "f32x2", "compensated")
aten = torch.ops.aten
#: indexing operations whose output shape is static unless an index is a
#: boolean mask
_INDEXING = (aten.index.Tensor, aten.index_put.default,
             aten.index_put_.default, aten._index_put_impl_.default)


def _host_read(func, args, kwargs):
    """Why ``func`` on ``args`` would make the host wait for the card, or
    ``None``."""
    if torch.Tag.data_dependent_output in func.tags:
        return "reads a value back"
    if func is aten.lift_fresh.default:
        return "a tensor made from host data (a copy from the host)"
    if torch.Tag.dynamic_output_shape in func.tags:
        if func in _INDEXING and not any(
                isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8)
                for i in args[1] if i is not None):
            return None
        return "a shape that depends on the data"
    if func is aten._to_copy.default:
        dst = kwargs.get("device")
        if dst is not None and torch.device(dst).type == "cpu" \
                and args[0].device.type != "cpu":
            return "a copy to the host"
    if func is aten.copy_.default and args[0].device.type == "cpu" \
            and args[1].device.type != "cpu":
        return "a copy to the host"
    return None


class HostReads(TorchDispatchMode):
    """Records each operation that would make the host wait for the card
    (``reads``: ``"op: why"``)."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _host_read(func, args, kwargs)
        if why:
            self.reads.append(f"{func}: {why}")
        return func(*args, **kwargs)


# --- the detector itself --------------------------------------------------


def test_the_detector_sees_each_kind_of_read():
    v = torch.arange(6.0)
    cases = {
        "reads a value back": lambda: float(v.sum()),
        "reads a value back ": lambda: bool(v[0] > 1),
        "a tensor made from host data": lambda: torch.as_tensor(2.0) * v,
        "a shape that depends on the data": lambda: v[v > 2],
        "a shape that depends on the data ": lambda: torch.nonzero(v),
    }
    for why, fn in cases.items():
        with HostReads() as mode:
            fn()
        assert len(mode.reads) == 1 and why.strip() in mode.reads[0], why
    idx = torch.tensor([2, 0, 1])
    with HostReads() as mode:  # none of these waits
        (v[idx] * 2.0).sum() + torch.where(v != 0, 1.0 / v, 0.0).sum()
        v.new_full((), 3.0)
        v.new_zeros(3).index_put_((idx,), v[:3])
    assert mode.reads == []


# --- one step and one chunk of rows, everywhere ------------------------------


@functools.lru_cache(maxsize=None)
def _problem(kind, mode):
    """``(operator, b, x_true)`` of the model problem (n = 256, half-band
    4) stored as ``kind`` in ``mode``, on the CPU."""
    if kind == "stencil":
        op, b, x_true = port.banded_model(N, k=K, fmt="stencil",
                                          device="cpu")
    else:
        sym, b, x_true = port.banded_model(N, k=K, device="cpu")
        op = port.from_coo(coo_from_scipy(sym.tocsr()), fmt=kind,
                           dtype=torch.float64, device="cpu")
    if mode == "f32x2":
        src = op if kind in ("symdia", "dia", "dense", "ell") else op.tocsr()
        return port.df_operator(src, device="cpu"), b, x_true
    if mode == "float32":
        op = op.astype(torch.float32)
    elif mode == "bf16":
        op = op.astype(torch.bfloat16)
    return op, b, x_true


def _setup(kind, mode, name, hook=None):
    """``(ctx, init_fn, step_fn, b, x0, aux)`` of a name's step, as a solve
    builds it (a block-banded operator, or ELL in its locality order, steps
    in its basis)."""
    op, b, x_true = _problem(kind, mode)
    p = tapi.prepare(name, op, b, preconditioner="jacobi",
                     dtype="f32x2" if mode == "f32x2" else None,
                     compensated=mode == "compensated", device="cpu",
                     w_replace=hook)
    aux = {"b": p.b, "x_true": p.aux_x_true(x_true)}
    return p.ctx, p.init_fn, p.step_fn, p.b, p.x0, aux


def _rows(ctx, s, aux):
    """A chunk's rows: every probe, the progress value and the norms."""
    out = [fn(ctx, s, aux) for fn in PROBES.values()]
    out.append(torch.sqrt(torch.abs(collapse(s["nu"]))))
    if "rho" in s:
        out.append(torch.sqrt(torch.abs(collapse(s["rho"]))))
    return out


def _reads_of_a_step(ctx, step_fn, state, aux):
    with HostReads() as mode:
        s = step_fn(ctx, state)
        _rows(ctx, s, aux)
    return mode.reads


@pytest.mark.parametrize("name", port.VARIANT_NAMES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_a_step_and_its_rows_read_nothing_back(kind, mode, name):
    ctx, init_fn, step_fn, b, x0, aux = _setup(kind, mode, name)
    state = init_fn(ctx, b, x0)
    assert _reads_of_a_step(ctx, step_fn, state, aux) == []
    if name.endswith("pcg"):
        # a norm riding the dot batch (the generic body)
        ctx.extra_norm = "rt"
        (state["rho"],) = ctx.dots((state["rt"], state["rt"]))
        assert _reads_of_a_step(ctx, step_fn, state, aux) == []


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", KINDS)
def test_gv_with_a_tensor_hook_reads_nothing_back(kind, mode):
    """The gv step with a replacement hook as a captured loop calls it: k
    a 0-d int64 tensor, the answer a bool tensor, the state's hook values
    tensors."""
    hook = graphs.checked_hook(lambda k, view: k % 3 == 0, stateful=False)
    ctx, init_fn, step_fn, b, x0, aux = _setup(kind, mode, "gv_pcg", hook)
    state = init_fn(ctx, b, x0)
    state["k"] = torch.tensor(2)
    assert _reads_of_a_step(ctx, step_fn, state, aux) == []

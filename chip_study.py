#!/usr/bin/env python3
"""Studies of the port's CUDA kernels on one NVIDIA GPU, beside chip_smoke.py.

    python3 chip_study.py check     # build, registers per kernel, check_dia
    python3 chip_study.py dfcheck   # build, registers, the double-word checks
    python3 chip_study.py ellcheck  # build, registers, check_ell (timed)
    python3 chip_study.py mutants   # do the checks catch a faulty kernel?
    python3 chip_study.py bounds    # launch bounds, timed in turns
    python3 chip_study.py halo      # whole-iteration kernel against the split
                                    # formulation as the band widens

Each study edits throw-away copies of ``new_cg_variants_tpu_torch/csrc`` in a
temporary directory (the sources in the checkout are never touched), builds
them with the port's own build (``_kernels.build(csrc=...)``), and runs them
through the port's own wrappers and ``chip_smoke.py``'s checks
(``_kernels.using``).  Every line printed is JSON; the numbers quoted in
PERF.md come from these lines.  Needs a CUDA device and ``nvcc``; exits
nonzero without them.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke as cs

#: this tree's kernel sources (what every study copies, whatever is bound)
CSRC = Path(__file__).resolve().parent / "new_cg_variants_tpu_torch" / "csrc"

#: faults a check must catch: what -> (source, text, replacement); every one
#: keeps its reads inside the kernel's buffers
MUTANTS = {
    "offset sign flipped (SpMV)": (
        "dia_spmv.cu", "x0 = sv0[c + off];",
        "x0 = sv0[max(0, min(vw - 1, c - off))];"),
    "diagonal d read at the offset of d - 1 (SpMV)": (
        "dia_spmv.cu", "const int off = soff[d];",
        "const int off = soff[d == 0 ? 0 : d - 1];"),
    "last diagonal dropped (SpMV)": (
        "dia_spmv.cu", "for (int d = 0; d < ndiag; ++d) {",
        "for (int d = 0; d < ndiag - 1; ++d) {"),
    "window staged one row off (SpMV)": (
        "dia_spmv.cu", "const long long g = i0 - h_lo + j + vorg;",
        "const long long g = i0 - h_lo + j + vorg + 1;"),
    "direct read ignores the vector's origin (SpMV)": (
        "dia_spmv.cu", "const long long g = i + off + vorg;",
        "const long long g = i + off;"),
    "halo rows left zero (full step)": (
        "family_specs.cuh",
        "if (g >= 0 && g < n) S::update(a, sc, g, idx < kTile, keep, mv);",
        "if (g >= 0 && g < n && idx < kTile) "
        "S::update(a, sc, g, true, keep, mv);"),
    "offset sign flipped (full step)": (
        "dia_family.cu", "const int j = c + soff[d];",
        "const int j = max(0, min(vw - 1, c - soff[d]));"),
    "beta p dropped from p2 (vector phase)": (
        "pipe_vector.cu", "const T p2 = r2 + beta * pv;", "const T p2 = r2;"),
    "wt2 formed from w (vector phase, prec)": (
        "pipe_vector.cu",
        "const T wt2 = __ldg(a.in[8] + i) - a1 * __ldg(a.in[9] + i);",
        "const T wt2 = __ldg(a.in[2] + i) - a1 * __ldg(a.in[9] + i);"),
}

#: faults of the double-word kernels (rows 9-11), held to chip_smoke.py's
#: double-word checks
DF_MUTANTS = {
    "contraction on: plain operators for the intrinsics (all three rows)": (
        "df_common.cuh",
        "__device__ __forceinline__ float rn_add(float a, float b) "
        "{ return __fadd_rn(a, b); }\n"
        "__device__ __forceinline__ float rn_sub(float a, float b) "
        "{ return __fsub_rn(a, b); }\n"
        "__device__ __forceinline__ float rn_mul(float a, float b) "
        "{ return __fmul_rn(a, b); }",
        "__device__ __forceinline__ float rn_add(float a, float b) "
        "{ return a + b; }\n"
        "__device__ __forceinline__ float rn_sub(float a, float b) "
        "{ return a - b; }\n"
        "__device__ __forceinline__ float rn_mul(float a, float b) "
        "{ return a * b; }"),
    "lo2 vh dropped (products)": (
        "df_common.cuh", "      rn_mul(al2, vh));", "      0.0f);"),
    "v.lo ignored (products)": (
        "df_common.cuh",
        "rn_add(rn_mul(a, vl), rn_mul(al, vh)), rn_mul(al, vl))",
        "rn_add(0.0f, rn_mul(al, vh)), 0.0f)"),
    "sloppy df_add, one 2Sum (all three rows)": (
        "df_common.cuh",
        "  const Pair t = two_sum(a.lo, b.lo);\n"
        "  const Pair u = fast_two_sum(s.hi, rn_add(s.lo, t.hi));\n"
        "  return fast_two_sum(u.hi, rn_add(u.lo, t.lo));",
        "  return fast_two_sum(s.hi, rn_add(s.lo, rn_add(a.lo, b.lo)));"),
    "power-of-two-only combine (vector phase)": (
        "df_pipe.cu", "const long long width = pow2_ceil(nb);",
        "const long long width = nb;"),
}

#: faults of the ELL kernel (row 12), held to chip_smoke.py's check_ell
ELL_MUTANTS = {
    "last slot dropped (ELL)": (
        "ell_spmv.cu", "for (int l = 0; l < L; ++l) {",
        "for (int l = 0; l < L - 1; ++l) {"),
    "v[i] read in place of v[idx] (ELL)": (
        "ell_spmv.cu", "const int j = __ldg(c + o);", "const int j = (int)i;"),
}


#: the minimum-blocks launch bound of the half-band SpMV, the DIA SpMV and the
#: full-DIA family kernel: (source, text, replacement taking the bound)
LAUNCH_BOUNDS = (
    ("sym_dia.cu",
     "__global__ void __launch_bounds__(kTile)\n    sym_dia_kernel",
     "__global__ void __launch_bounds__(kTile, {})\n    sym_dia_kernel"),
    ("dia_spmv.cu", "constexpr int kDiaMinBlocks = sizeof(T) == 4 ? 8 : 4;",
     "constexpr int kDiaMinBlocks = {};"),
    ("dia_family.cu",
     "constexpr int kDiaFamilyMinBlocks = sizeof(T) == 4 ? 6 : 3;",
     "constexpr int kDiaFamilyMinBlocks = {};"),
)


def emit(study, **fields):
    print(json.dumps({"study": study, **fields}), flush=True)


def build_edited(stack, edits):
    """Build a copy of the kernel sources with ``edits`` = [(source, text,
    replacement)] applied, in a temporary directory that lives as long as
    ``stack``.  Returns the loaded libraries by source (for
    ``_kernels.using``) and the build logs' register lines."""
    from new_cg_variants_tpu_torch.ops import _kernels

    tmp = Path(stack.enter_context(
        tempfile.TemporaryDirectory(prefix="ncgv_study_")))
    shutil.copytree(CSRC, tmp / "csrc")
    for source, text, replacement in edits:
        path = tmp / "csrc" / source
        body = path.read_text()
        if body.count(text) != 1:
            raise ValueError(f"{source}: {text!r} found "
                             f"{body.count(text)} times, expected once")
        path.write_text(body.replace(text, replacement))
    paths = _kernels.build(csrc=tmp / "csrc", build_root=tmp / "_build")
    libs = {src: _kernels.load(src, p) for src, p in paths.items()}
    logs = {src: [ln for ln in p.with_suffix(".log").read_text().splitlines()
                  if "registers" in ln or "Compiling" in ln]
            for src, p in paths.items()}
    return libs, logs


def dia_checks(torch, card):
    """check_dia's checks, counted instead of raised and not timed: (checks,
    failed, worst error among the failed)."""
    lines = []
    failed = cs.dia_checks(torch, card, None, lines.append)
    errs = [max(r["max_err"], r.get("max_dot_err", 0.0)) for r in failed]
    honest = [max(r["max_err"], r.get("max_dot_err", 0.0)) for r in lines
              if r not in failed]
    return dict(checks=len(lines), failed=len(failed),
                failed_err_min=min(errs, default=None),
                failed_err_max=max(errs, default=None),
                passed_err_max=max(honest, default=None))


def df_checks(torch, card):
    """check_df's checks, counted instead of raised and not timed."""
    lines = []
    failed = cs.df_checks(torch, card, None, lines.append)
    return dict(checks=len(lines), failed=len(failed),
                failed_checks=sorted({r["kernel"] for r in failed}),
                passed_checks=[(r["kernel"], r["n"]) for r in lines
                               if r not in failed],
                passed_abs_err_max=max((r["max_abs_err"] for r in lines
                                        if r not in failed), default=None))


def ell_checks(torch, card):
    """check_ell's checks, counted instead of raised and not timed."""
    lines = []
    failed = cs.ell_checks(torch, card, None, lines.append)
    errs = [r["max_err"] for r in failed]
    return dict(checks=len(lines), failed=len(failed),
                failed_err_min=min(errs, default=None),
                failed_err_max=max(errs, default=None),
                passed_checks=[(r["shape"], r["dtype"]) for r in lines
                               if r not in failed],
                passed_err_max=max((r["max_err"] for r in lines
                                    if r not in failed), default=None))


def study_check(torch, card):
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = build_edited(stack, [])
        for src, lines in logs.items():
            emit("check", source=src, ptxas=lines)
        with _kernels.using(libs):
            cs.check_dia(torch, card, {})
    emit("check", ok=True)


def study_dfcheck(torch, card):
    """The quick first call after touching a double-word kernel: build,
    registers, the double-word checks (timed)."""
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = build_edited(stack, [])
        for src in ("df_spmv.cu", "df_pipe.cu"):
            emit("dfcheck", source=src, ptxas=logs[src])
        with _kernels.using(libs):
            cs.check_df(torch, card, {})
    emit("dfcheck", ok=True)


def study_ellcheck(torch, card):
    """The first call after touching the ELL kernel: build, registers,
    check_ell (timed).  Its mutants run in ``mutants``."""
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = build_edited(stack, [])
        emit("ellcheck", source="ell_spmv.cu", ptxas=logs["ell_spmv.cu"])
        with _kernels.using(libs):
            timings = {}
            cs.check_ell(torch, card, timings)
            emit("ellcheck", timings=timings)
    emit("ellcheck", ok=True)


def study_mutants(torch, card):
    from new_cg_variants_tpu_torch.ops import _kernels

    runs = [(what, edit, dia_checks) for what, edit in
            {"as committed": None, **MUTANTS}.items()]
    runs += [(what, edit, df_checks) for what, edit in
             {"as committed (double-word checks)": None,
              **DF_MUTANTS}.items()]
    runs += [(what, edit, ell_checks) for what, edit in
             {"as committed (ELL checks)": None, **ELL_MUTANTS}.items()]
    for what, edit, checks in runs:
        with contextlib.ExitStack() as stack:
            libs, _ = build_edited(stack, [edit] if edit else [])
            with _kernels.using(libs):
                emit("mutants", mutant=what, source=edit and edit[0],
                     **checks(torch, card))


def timed_in_turns(torch, variants, cases, rounds=2):
    """``variants``: name -> edits; ``cases``: name -> callable returning
    tensors.  Times every case under every variant in turns (A B .. B A per
    round) and compares each case's outputs with the first variant's bit for
    bit.  Returns {case: {variant: [ms, ...]}}, {case: {variant: same}} and
    the build logs by variant."""
    from new_cg_variants_tpu_torch.ops import _kernels

    with contextlib.ExitStack() as stack:
        libs, logs = {}, {}
        for name, edits in variants.items():
            libs[name], logs[name] = build_edited(stack, edits)
        names = list(variants)
        times = {c: {v: [] for v in names} for c in cases}
        same = {c: {} for c in cases}
        for c, fn in cases.items():
            with _kernels.using(libs[names[0]]):
                ref = [t.clone() for t in fn()]
            for v in names:
                with _kernels.using(libs[v]):
                    out = fn()
                    torch.cuda.synchronize()
                same[c][v] = all(bool(torch.equal(a, b))
                                 for a, b in zip(out, ref))
            for _ in range(rounds):
                for v in names + names[::-1]:
                    with _kernels.using(libs[v]):
                        times[c][v].append(cs.time_ms(torch, fn, 50))
        return times, same, logs


def flat(out):
    """The tensors of a wrapper's return value (vectors, then the dots)."""
    if not isinstance(out, (tuple, list)):
        return [out]
    return [t for o in out for t in flat(o)]


def study_bounds(torch, card):
    """Minimum-blocks launch bounds of the SpMV kernels and the full-DIA
    family kernel, against none, at the main path's shapes (f32)."""
    from new_cg_variants_tpu_torch.ops import fused_family as ff
    from new_cg_variants_tpu_torch.ops import fused_step as fs
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp
    from new_cg_variants_tpu_torch.ops import sym_dia as sd

    rng = np.random.default_rng(0)
    n, dt = cs.N, torch.float32
    vecs = {nm: torch.as_tensor(
        rng.uniform(0.5, 2.0, n) if nm == "d" else rng.standard_normal(n),
        dtype=dt, device="cuda") for nm in "d x r w u p s rt st wt ut".split()}
    v, w = vecs["x"], vecs["r"]
    sym_offs = tuple(range(cs.K_BAND))
    offs = cs.DIA_MAIN_OFFSETS
    sym = cs.random_band(torch, sym_offs, n, dt, rng)
    dia = cs.random_dia(torch, offs, n, dt, rng)
    wide = cs.random_dia(torch, cs.WIDE_OFFSETS, n, dt, rng)
    scal = {nm: torch.tensor(val, dtype=dt, device="cuda")
            for nm, val in cs.SCALAR_VALUES.items()}
    cases = {
        "sym_dia_spmv": lambda: flat(sd.sym_dia_spmv(sym_offs, sym, v)),
        "sym_dia_spmv2": lambda: flat(sd.sym_dia_spmv2(sym_offs, sym, v, w)),
        "dia_spmv": lambda: flat(sp.dia_spmv(offs, dia, v)),
        "dia_spmv2": lambda: flat(sp.dia_spmv2(offs, dia, v, w)),
        "dia_spmv2 wide": lambda: flat(sp.dia_spmv2(cs.WIDE_OFFSETS, wide, v, w)),
    }
    for module, table in ((fs, cs.DIA_STEP), (ff, cs.DIA_FAMILY)):
        for entry, (ins, scs, _, _, nmv, _, kw, _) in table.items():
            if nmv:
                fn = getattr(module, entry.split("/")[0])
                args = ([vecs[nm] for nm in ins.split()]
                        + [scal[nm] for nm in scs.split()])
                cases[entry] = (lambda fn=fn, args=args, kw=kw:
                                flat(fn(offs, dia, *args, **kw)))

    def variant(*blocks):
        return [(source, text, replacement.format(k))
                for (source, text, replacement), k in zip(LAUNCH_BOUNDS, blocks)]

    variants = {"as committed": [], "min blocks 1": variant(1, 1, 1),
                "min blocks 4": variant(4, 4, 4),
                "min blocks 5": variant(5, 5, 5),
                "min blocks 6": variant(5, 6, 6),
                "min blocks 8": variant(5, 8, 8)}
    times, same, logs = timed_in_turns(torch, variants, cases)
    for name, by_src in logs.items():
        for src in ("sym_dia.cu", "dia_spmv.cu", "dia_family.cu"):
            emit("bounds", variant=name, source=src, ptxas=by_src[src])
    for c in cases:
        emit("bounds", case=c, card=card,
             ms={v: [round(t, 5) for t in ts] for v, ts in times[c].items()},
             same_bits_as_committed=same[c])


def study_halo(torch, card):
    """The whole-iteration kernel against the split formulation (vector-phase
    kernel, then the 2-RHS SpMV kernel) on a 5-diagonal band (-h, -1, 0, 1,
    h) and on a dense band of 2h+1 diagonals, as h grows to the kernel's
    limit; f32, n = 4,194,304 (5 diagonals) or 655,360 (dense band)."""
    from new_cg_variants_tpu_torch.ops import fused_step as fs
    from new_cg_variants_tpu_torch.ops import spmv_dia as sp

    rng = np.random.default_rng(0)
    dt = torch.float32
    a1, beta = (torch.tensor(x, dtype=dt, device="cuda") for x in (0.37, 0.61))
    for kind, n, hs in (("5 diagonals", cs.WIDE_N, (16, 64, 128, 256)),
                        ("dense band", cs.N, (8, 31, 64))):
        vecs = [torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
                for _ in range(6)]
        for h in hs:
            offs = ((-h, -1, 0, 1, h) if kind == "5 diagonals"
                    else tuple(range(-h, h + 1)))
            data = cs.random_dia(torch, offs, n, dt, rng)

            def split():
                x, r, w, p, s, dots = fs.fused_pipe_vector_phase(*vecs, a1, beta)
                return sp.dia_spmv2(offs, data, s, r)

            full = cs.time_ms(
                torch, lambda: fs.fused_pipe_full_step(offs, data, *vecs, a1,
                                                       beta), 50)
            parts = cs.time_ms(torch, split, 50)
            full2 = cs.time_ms(
                torch, lambda: fs.fused_pipe_full_step(offs, data, *vecs, a1,
                                                       beta), 50)
            parts2 = cs.time_ms(torch, split, 50)
            emit("halo", band=kind, n=n, h=h, ndiag=len(offs), card=card,
                 full_step_ms=[full, full2], split_ms=[parts, parts2],
                 supports_full_step=fs.supports_full_step(offs))
            del data


def main(argv):
    import torch

    studies = {"check": study_check, "dfcheck": study_dfcheck,
               "ellcheck": study_ellcheck, "mutants": study_mutants,
               "bounds": study_bounds, "halo": study_halo}
    if len(argv) != 2 or argv[1] not in studies:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_study: no CUDA device available", file=sys.stderr)
        return 1
    card = cs.card_line()
    emit(argv[1], card=card, torch=torch.__version__, cuda=torch.version.cuda)
    studies[argv[1]](torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

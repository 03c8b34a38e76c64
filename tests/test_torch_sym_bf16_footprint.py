"""Shared memory of the half-band kernels with a bf16 band: the ring the band
is staged through (csrc/sym_common.cuh:sym_rows_ring) counted by the wrappers'
check, independent of the number of diagonals, and float32 / float64 bands,
which take no ring, sized as before."""

import re
import types
from pathlib import Path

import pytest
import torch

from new_cg_variants_tpu_torch.ops import _kernels
from new_cg_variants_tpu_torch.ops import sym_dia as tsd
from new_cg_variants_tpu_torch.ops import sym_fused as tsf

BF16 = torch.bfloat16
CSRC = Path(tsd.__file__).parent.parent / "csrc"
ENTRIES = list(tsf._FAMILY_ENTRIES)


class _FakeCudaTensor(types.SimpleNamespace):
    """Just enough of a CUDA tensor for ``check_kernel_args``."""

    def is_contiguous(self):
        return True


def _band(offsets, dtype, n=4096):
    return _FakeCudaTensor(is_cuda=True, dtype=dtype, shape=(len(offsets), n),
                           device=torch.device("cuda", 0))


def _check(offsets, dtype, entry):
    """``check_kernel_args`` as the wrapper of ``entry`` calls it (the SpMV
    entries: ``sym_dia_spmv`` with 1 RHS, ``sym_dia_spmv2`` with 2)."""
    if entry.startswith("sym_dia_spmv"):
        nvec = 2 if entry == "sym_dia_spmv2" else 1
        return tsd.check_kernel_args(offsets, _band(offsets, dtype), (), nvec,
                                     entry=entry)
    nmv = tsf._FAMILY_ENTRIES[entry][3]
    return tsd.check_kernel_args(offsets, _band(offsets, dtype), (), nmv,
                                 entry=entry, tile=_kernels.SYM_FAMILY_TILE)


def _need(h, entry, ring):
    if entry.startswith("sym_dia_spmv"):
        nvec = 2 if entry == "sym_dia_spmv2" else 1
        return tsd.kernel_smem_bytes(h, nvec, 4, ring=ring)
    return tsd.kernel_smem_bytes(h, tsf._FAMILY_ENTRIES[entry][3], 4,
                                 _kernels.SYM_FAMILY_TILE, ring)


@pytest.mark.parametrize("name, value", [("kRingValues", _kernels.RING_VALUES),
                                         ("kRingStages", _kernels.RING_STAGES)])
def test_ring_constants_match_the_source(name, value):
    text = (CSRC / "sym_common.cuh").read_text()
    assert re.findall(rf"constexpr int {name} = (\d+);", text) == [str(value)]


def test_ring_bytes_at_the_main_shape():
    # h = 31 leads by 32 values; stages of 16 diagonals of the SpMV's 256
    # rows or 8 of the family kernel's 512
    assert tsd.ring_bytes(31) == 2 * 16 * (256 + 32) * 2
    assert tsd.ring_bytes(31, _kernels.SYM_FAMILY_TILE) == 2 * 8 * (512 + 32) * 2
    assert tsd.ring_bytes(32) == tsd.ring_bytes(31)
    assert tsd.ring_bytes(33) == 2 * 16 * (256 + 40) * 2
    assert tsd.ring_bytes(0) == 2 * 16 * 256 * 2


@pytest.mark.parametrize("entry", ["sym_dia_spmv", "sym_dia_spmv2"] + ENTRIES)
@pytest.mark.parametrize("h", [31, 127, 255])
def test_bf16_footprint_is_independent_of_the_number_of_diagonals(h, entry):
    """Two stored diagonals or h + 1 (up to MAX_DIAGS) take the same shared
    memory: the ring holds RING_STAGES groups, not the band."""
    for offsets in ((0, h), tuple(range(min(h, _kernels.MAX_DIAGS - 1))) + (h,)):
        assert _check(offsets, BF16, entry)[1] == h
    assert _need(h, entry, True) < tsd.MAX_SMEM_BYTES


@pytest.mark.parametrize("entry", ["sym_dia_spmv", "sym_dia_spmv2"] + ENTRIES)
@pytest.mark.parametrize("ndiag", [128, 200, 256])
def test_wide_bf16_band_fits_every_entry(ndiag, entry):
    """A bf16 band of up to MAX_DIAGS diagonals passes every entry's check,
    and so does the widest the auto route stores half-band (h = 127)."""
    offsets = tuple(range(ndiag))
    assert _check(offsets, BF16, entry) == (4096, ndiag - 1, "bf16")


@pytest.mark.parametrize("entry", ["sym_dia_spmv", "sym_dia_spmv2"] + ENTRIES)
def test_bf16_footprint_limit_names_the_entry(entry):
    """A half-band of 8000 needs a ring of 16 or 32 segments of 8,000 values
    or more: over a block's shared memory, and the error names the entry.  The
    same band in float32, which takes no ring, fits the windows of 1 and 2
    vectors."""
    offsets = (0, 1, 8000)
    need = _need(8000, entry, True)
    assert need > tsd.MAX_SMEM_BYTES
    with pytest.raises(ValueError,
                       match=f"{re.escape(entry)}: .*bf16 band ring.* {need} "
                             "bytes"):
        _check(offsets, BF16, entry)
    assert _check(offsets, torch.float32, entry)[1] == 8000


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("tile", [_kernels.KERNEL_TILE,
                                  _kernels.SYM_FAMILY_TILE])
@pytest.mark.parametrize("nvec", [1, 2])
def test_float_footprints_are_unchanged(itemsize, tile, nvec):
    """float32 and float64 bands are read from device memory: their blocks
    hold the vector windows, the reduction scratch and the offsets, no
    ring."""
    for h in (0, 31, 127, 4000):
        assert tsd.kernel_smem_bytes(h, nvec, itemsize, tile) == (
            (nvec * (tile + 2 * h) + 32 * (tile // 256)) * itemsize
            + 4 * _kernels.MAX_DIAGS)
        assert tsd.kernel_smem_bytes(h, nvec, itemsize, tile, ring=True) > (
            tsd.kernel_smem_bytes(h, nvec, itemsize, tile))


@pytest.mark.parametrize("dtype, sfx", [(torch.float32, "f32"),
                                        (torch.float64, "f64")])
def test_float_bands_take_no_ring(dtype, sfx):
    """The widest float32 / float64 half-band the windows allow still passes,
    where a bf16 band of that width, with its ring, does not."""
    itemsize = dtype.itemsize
    limit = max(h for h in range(1, 40_000)
                if tsd.kernel_smem_bytes(h, 2, itemsize) <= tsd.MAX_SMEM_BYTES)
    offsets = (0, 1, limit)
    assert tsd.check_kernel_args(offsets, _band(offsets, dtype), (), 2) == (
        4096, limit, sfx)
    with pytest.raises(ValueError, match="bf16 band ring"):
        tsd.check_kernel_args(offsets, _band(offsets, BF16), (), 2)
    with pytest.raises(ValueError, match="vector windows needs"):
        tsd.check_kernel_args((0, 1, limit + 1),
                              _band((0, 1, limit + 1), dtype), (), 2)

"""The port's profiling utilities (``utils/``): trace, parse, environment.

* ``trace_analysis.phase_breakdown`` on a synthetic ``torch.profiler``
  Chrome trace that names every ``__global__`` kernel of ``csrc/*.cu`` (as
  the profiler prints a template instance) and torch's and cuBLAS's kernels:
  each port kernel lands in its bucket of ``chip_smoke.py``'s
  ``KERNEL_PHASES`` (a product, fused or not, in spmv; a vector phase in
  vector), nothing in "other";
* the same parser on a real CPU-only trace of a few solver steps written by
  ``profiling.trace``: events parse, the breakdown's fractions sum to one;
* ``env_info`` holds torch's, the card's and the host's long double
  fields and no JAX ones.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import new_cg_variants_tpu_torch as port
from new_cg_variants_tpu_torch.utils import env_info, profiling
from new_cg_variants_tpu_torch.utils import trace_analysis as ta

from chip_smoke import KERNEL_PHASES

CSRC = Path(__file__).resolve().parent.parent / "new_cg_variants_tpu_torch" \
    / "csrc"


def global_kernels():
    names = set()
    for f in CSRC.glob("*.cu"):
        text = f.read_text()
        names |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", text))
    return sorted(names)


def extern_entries():
    names = set()
    for f in CSRC.glob("*.cu"):
        text = f.read_text()
        block = text[text.index('extern "C"'):]
        names |= set(re.findall(r"^int\s+(\w+)\s*\(", block, re.M))
    return sorted(names)


def phase_by_table(name):
    """The bucket ``KERNEL_PHASES`` gives a kernel or C entry name."""
    hits = {phase for k, phase in KERNEL_PHASES.items()
            if name.startswith(k[:-len("_kernel")])}
    assert len(hits) == 1, name
    return hits.pop()


TORCH_KERNELS = {
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
    "float, float>::operator()>, unsigned int, float, 4, 4> >": "dots/reduce",
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >":
        "vector",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "BinaryFunctor<float, float, float, at::native::binary_internal::"
    "MulFunctor<float> > >": "vector",
    "void dot_kernel<float, 128, 0, cublasDotParams<cublasGemvTensorStrided"
    "<float const>, cublasGemvTensorStrided<float> > >": "dots/reduce",
    "void reduce_1Block_kernel<float, 128, 7, cublasGemvTensorStrided<float>"
    ", cublasGemvTensorStrided<float>, cublasGemvTensorStrided<float> >":
        "dots/reduce",
    "void gemv2T_kernel_val<int, int, double, double, double, double, 128, "
    "16, 4, 4, false, false>": "spmv",
    "Memcpy DtoH (Device -> Pageable)": "vector",
    "Memset (Device)": "vector",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL": "collectives",
}


def synthetic_trace(path):
    """A Chrome trace as ``torch.profiler`` writes it: one host process,
    one GPU process with a stream, kernels as complete events."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7 "}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 1.0, "dur": 4.0},
    ]
    ts = 100.0
    names = {f"void ncgv::{k}<float, ncgv::PipeSpec<true> >(float const*)":
             KERNEL_PHASES[k] for k in global_kernels()}
    names.update(TORCH_KERNELS)
    for name in names:
        events.append({"ph": "X", "cat": "gpu_memcpy" if "Memcpy" in name
                       else "gpu_memset" if "Memset" in name else "kernel",
                       "name": name, "pid": 0, "tid": 7, "ts": ts,
                       "dur": 2.0})
        ts += 3.0
    path.write_text(json.dumps({"traceEvents": events}))
    return names


def test_every_port_kernel_has_a_stem():
    kernels = global_kernels()
    assert kernels == sorted(KERNEL_PHASES)
    for name in kernels + extern_entries():
        assert any(stem in name for stem in ta.PORT_KERNELS), name
    for stem in ta.PORT_KERNELS:
        assert any(stem in k for k in kernels), stem


def test_synthetic_trace_buckets(tmp_path):
    want = synthetic_trace(tmp_path / "host_1.123.pt.trace.json")
    events = ta.load_trace_events(str(tmp_path))
    bd = ta.phase_breakdown(str(tmp_path))
    assert "other" not in bd["phases"]
    assert bd["events"] == len(want)
    assert bd["total_us"] == pytest.approx(2.0 * len(want))
    rows = ta.op_breakdown(events, top=1000)
    assert {r["name"] for r in rows} == set(want)  # host events left out
    for name, phase in want.items():
        assert ta.phase_of(name) == phase, name
    for name in extern_entries():
        assert ta.phase_of(name) == phase_by_table(name), name
    assert {ta.phase_of(n) for n in want if "ncgv::" in n} == {"spmv",
                                                               "vector"}
    assert "device time" in ta.format_table(bd)


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    op, b, _ = port.banded_model(4096, k=8, device="cpu")
    with profiling.trace(str(d)) as prof:
        out = port.run("pipe_pr_cg", op, b, max_iter=10, device="cpu")
    assert prof is not None and out["x"].shape == (4096,)
    return str(d)


def test_cpu_trace_parses(cpu_trace):
    path = Path(ta._newest_trace_file(cpu_trace))
    assert path.name.endswith(".pt.trace.json")
    events = ta.load_trace_events(cpu_trace)
    assert len(events) > 10
    assert all("name" in e and e["dur"] >= 0 for e in events)
    rows = ta.op_breakdown(events, top=10)
    assert rows and rows[0]["total_us"] >= rows[-1]["total_us"]
    assert all(0 <= r["frac"] <= 1 for r in rows)


def test_cpu_trace_phase_breakdown(cpu_trace):
    bd = ta.phase_breakdown(cpu_trace)
    assert bd["total_us"] > 0 and bd["events"] > 0
    fr = [row["frac"] for row in bd["phases"].values()]
    assert abs(sum(fr) - 1.0) < 1e-6
    assert {"vector", "dots/reduce"} <= set(bd["phases"])
    txt = ta.format_table(bd)
    assert "device time" in txt and "%" in txt


def test_host_fallback_counts_outermost_operators():
    ev = [dict(name="aten::add", dur=10.0, ts=0.0, cat="cpu_op", pid=1,
               tid=1),
          dict(name="aten::empty", dur=2.0, ts=1.0, cat="cpu_op", pid=1,
               tid=1),
          dict(name="aten::dot", dur=5.0, ts=20.0, cat="cpu_op", pid=1,
               tid=1),
          dict(name="aten::mul", dur=3.0, ts=2.0, cat="cpu_op", pid=1,
               tid=2)]
    bd = ta.phase_breakdown(ev)
    assert bd["total_us"] == 18.0 and bd["events"] == 3
    assert bd["phases"]["dots/reduce"]["us"] == 5.0


def test_env_info(tmp_path):
    info = env_info.env_info()
    assert info["torch"] == torch.__version__
    assert info["longdouble"]["eps"] == float(np.finfo(np.longdouble).eps)
    assert info["device_count"] == len(info["devices"])
    assert not any("jax" in k or "tpu" in k.lower() or "xla" in k
                   for k in info)
    path = env_info.write_env_info(tmp_path)
    assert json.loads(path.read_text())["machine"] == info["machine"]
    call = env_info.write_call_file(tmp_path, "x", ["a", "b"])
    assert call.read_text() == "a b\n"

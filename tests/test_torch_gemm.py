"""The port's GEMM (``ops/kernels.linear``: ``tb_linear`` / ``wa_linear``,
``csrc/gemm_sm90.cuh``) on the CPU: the 3xTF32 scheme that keeps
``wa_linear``'s f32 contract on the tensor cores, emulated in torch, and the
kernel names that the card's reports look up.  The kernels themselves run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``, on the card."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu_torch import profiling
from ultrasound_modeling_tpu_torch.ops import kernels as K

REPO = Path(__file__).resolve().parent.parent


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its top 19 bits (the
    low 13 mantissa bits masked off, 0xffffe000)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_lo(x: torch.Tensor) -> torch.Tensor:
    """x minus its TF32 truncation, rounded to the nearest TF32 value (the
    kernel's ``tf32_lo``: add 0x1000, then mask)."""
    lo = x - _tf32(x)
    return ((lo.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


@pytest.mark.parametrize("k", [512, 1280, 2048])
def test_3xtf32_keeps_the_f32_contract(k):
    """hi = x & 0xffffe000 (the raw tile as the tensor core reads it), lo =
    x - hi rounded to TF32; A_lo.W_hi + A_hi.W_lo + A_hi.W_hi summed in f32
    stays within 1e-5 of max|out| against float64 at the port's depths
    (TransUNet 512, ViT 1280 and the MLP's 2048), where one TF32 product
    (hi alone) misses by far."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((64, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((96, k)) * k ** -0.5)
                         .astype(np.float32))
    want = a.double() @ w.double().t()
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32_lo(a), _tf32_lo(w)
    got = a_lo @ w_hi.t() + a_hi @ w_lo.t() + a_hi @ w_hi.t()
    bound = 1e-5 * want.abs().max().item()
    assert (got.double() - want).abs().max().item() <= bound
    one = a_hi @ w_hi.t()
    assert (one.double() - want).abs().max().item() > 10 * bound


def _global_kernels():
    """Names of every ``__global__`` function in csrc/*.cu and *.cuh."""
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
        r"(\w+)\s*\(")
    names = set()
    for src in sorted(K.CSRC.glob("*.cu*")):
        names.update(pattern.findall(src.read_text()))
    return names


def test_reported_kernel_names_exist_in_csrc():
    """Every kernel function that chip_smoke.py's tensor-core report and
    profiling.py's breakdown look up by name is a ``__global__`` of csrc/:
    a rename cannot silently empty a report row or a breakdown column."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    names = _global_kernels()
    assert "linear_wgmma_kernel" in names and "attention_fwd_kernel" in names
    looked_up = set(chip_smoke.TENSOR_CORE_KERNELS)
    for keys in profiling.GROUPS.values():
        looked_up.update(keys)
    assert looked_up <= names, sorted(looked_up - names)
    for pattern in chip_smoke.GEMM_BUILDS.values():
        assert any(n in pattern for n in names), pattern

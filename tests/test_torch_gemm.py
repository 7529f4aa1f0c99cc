"""The port's GEMM (``ops/kernels.linear``: ``tb_linear`` / ``wa_linear``,
``csrc/gemm_sm90.cuh``) on the CPU: the 3xTF32 scheme that keeps
``wa_linear``'s f32 contract on the tensor cores, emulated in torch, and the
kernel names that the card's reports look up.  The kernels themselves run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``, on the card."""

import importlib.util
import inspect
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


def test_a_bf16_upcast_has_no_tf32_lo_part():
    """An f32 A upcast from bf16 is exactly TF32 (8 significant bits of the
    11 TF32 keeps): its lo part is 0, so A_lo.W_hi adds exact zeros and the
    two-pass sum A_hi.W_lo + A_hi.W_hi has the same bits as the three-pass
    one; a random f32 A is not TF32."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((288, 96)) * 96 ** -0.5)
                         .astype(np.float32))
    a16 = a.to(torch.bfloat16).float()
    assert K.is_tf32(a16) and not K.is_tf32(a)
    assert torch.equal(_tf32(a16), a16)
    assert not _tf32_lo(a16).any()
    w_hi, w_lo = _tf32(w), _tf32_lo(w)
    three = _tf32_lo(a16) @ w_hi.t() + a16 @ w_lo.t() + a16 @ w_hi.t()
    two = a16 @ w_lo.t() + a16 @ w_hi.t()
    assert torch.equal(three, two)


def test_linear_a_tf32_claim_is_checked_on_the_cpu():
    """``linear(..., a_tf32=True)`` on CPU tensors returns the plain product
    for an exactly-TF32 A and raises for any other (or a bf16 A)."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 96, generator=g)
    w = torch.randn(16, 96, generator=g)
    a16 = a.to(torch.bfloat16).float()
    assert torch.equal(K.linear(a16, w, a_tf32=True), K.linear_plain(a16, w))
    with pytest.raises(ValueError, match="below TF32"):
        K.linear(a, w, a_tf32=True)
    with pytest.raises(TypeError):
        K.linear(a.to(torch.bfloat16), w.to(torch.bfloat16), a_tf32=True)


def _stage_products(frames):
    """(M, N, K) of K4's four products at each Swin stage for `frames`
    frames: qkv, proj (and the backward's do), dx."""
    out = []
    for tokens, c in ((1280, 96), (320, 192), (80, 384), (27, 768)):
        m = frames * tokens
        out.append([(m, 3 * c, c), (m, c, c), (m, c, 3 * c)])
    return out


H100_SMS = 132


# the schedule of each of K4's products (qkv, proj and do, dx) at the four
# Swin stages for 64 and 32 frames, f32 x (three passes) and bf16 x (the
# qkv and do products of an upcast bf16 drop the A_lo pass): 1 the narrow
# schedule, 0 the 128 x 128 tile
PLAN_AT_STAGES = {
    (64, False): [(1, 1, 1), (1, 1, 1), (1, 0, 0), (0, 1, 1)],
    (64, True): [(1, 1, 1), (1, 1, 1), (1, 1, 0), (1, 1, 1)],
    (32, False): [(1, 1, 1), (1, 1, 1), (1, 1, 1), (0, 1, 1)],
    (32, True): [(1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 1)]}


@pytest.mark.parametrize("frames,a_tf32", sorted(PLAN_AT_STAGES))
def test_linear_plan_at_the_swin_stages(frames, a_tf32):
    """K4's f32 products at the four Swin stages take the narrow schedule
    (min(128 x 96 tiles, one block an SM) persistent blocks) except where
    its 96-wide tiles make a wave more than the 128 x 128 tile's (stage 3's
    projections and stage 4's qkv at b64, stage 4's qkv at b32, f32 x);
    dropping the A_lo pass (a bf16 x's qkv and do) tips all but stage 3's
    dx at b64 back.  dx never drops it."""
    bm, bn = K.NARROW_TILE
    assert (bm, bn, K.NARROW_BLOCKS_PER_SM) == (128, 96, 1)
    want = PLAN_AT_STAGES[(frames, a_tf32)]
    for stage, products in enumerate(_stage_products(frames)):
        for (m, n, k), narrow, tf32 in zip(products, want[stage],
                                            (a_tf32, a_tf32, False)):
            grid = K.linear_plan(m, n, k, torch.float32, H100_SMS, tf32)
            tiles = -(-m // bm) * -(-n // bn)
            assert grid == (min(tiles, H100_SMS) if narrow else 0), (
                stage, m, n, k, tf32)
    # stage 1's qkv at b64: 640 x 3 tiles on 132 blocks (the 128 x 128 tile
    # pads N = 288 to 384); stage 4's projection: 14 x 8 = 112 tiles
    assert K.linear_plan(81920, 288, 96, torch.float32, H100_SMS) == 132
    assert K.linear_plan(1728, 768, 768, torch.float32, H100_SMS) == 112


@pytest.mark.parametrize("m,n,k", [(5120, 1536, 512), (5120, 512, 512),
                                   (10240, 3840, 1280), (10240, 1280, 1280),
                                   (1280, 3840, 1280), (2560, 1536, 512)])
def test_linear_plan_keeps_the_128_tile_at_transunet_vit_and_k5_widths(m, n, k):
    """The TransUNet's (C 512) and the ViT's (C 1280) K4 products and K5's
    keep the 128 x 128 schedule (plan 0), as does every bf16 product."""
    assert K.linear_plan(m, n, k, torch.float32, H100_SMS) == 0
    assert K.linear_plan(m, n, k, torch.bfloat16, H100_SMS) == 0
    assert K.linear_plan(81920, 288, 96, torch.bfloat16, H100_SMS) == 0


def test_k4_redesign_kernels_are_reported():
    """The two kernels of K4's forward at the Swin's shapes are
    ``__global__`` functions of csrc/, on chip_smoke.py's tensor-core report
    (HMMA / HGMMA required) and in profiling.py's own columns."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    names = _global_kernels()
    for kern, group in (("wa_window_fwd_kernel", "k4_window_core"),
                        ("linear_narrow_kernel", "narrow_gemm")):
        assert kern in names
        assert kern in chip_smoke.TENSOR_CORE_KERNELS
        assert profiling.GROUPS[group] == (kern,)
    # the older columns do not also count them
    for group, keys in profiling.GROUPS.items():
        for key in keys:
            for kern in ("wa_window_fwd_kernel", "linear_narrow_kernel"):
                assert key == kern or key not in kern, (group, key)


def test_window_attention_drops_the_a_lo_pass_only_for_a_bf16_x():
    """K4's forward asks its qkv product to drop the A_lo pass when x is
    bf16 (the upcast is exactly TF32), and neither product otherwise."""
    rng = np.random.default_rng(2)
    c, heads = 96, 3
    ws = [torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32))
          for s in ((3 * c, c), (3 * c,), (c, c), (c,))]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((4, 20, c)).astype(
            np.float32)).to(dtype)
        calls = []

        def lin(a, w, b=None, out_dtype=torch.float32, a_tf32=False):
            calls.append(a_tf32)
            if a_tf32:
                assert K.is_tf32(a)
            return K.linear_plain(a, w, b, out_dtype=out_dtype)

        K._window_attention(x, *ws, heads, None, 32 ** -0.5, lin,
                            K.attention_core_plain)
        assert calls == [dtype == torch.bfloat16, False]


# rows of K4's backward at each Swin stage a frame (64x20, 32x10, 16x5 and
# 9x3 tokens) and its C
SWIN_ROWS_C = ((1280, 96), (320, 192), (80, 384), (27, 768))


@pytest.mark.parametrize("frames", [32, 64])
@pytest.mark.parametrize("sms", [132, 114])
def test_wgrad_plan_splits_the_rows_by_shape_and_card(frames, sms):
    """The weight-gradient kernel's split of the rows is a function of the
    shape and the SM count alone; its runs are whole 32-row k-blocks that
    cover the rows exactly once; its blocks stay within the blocks an SM it
    fills, so the partial sums never outgrow one output tile a block; the
    Swin's stage 4 takes no split, and stage 1 a deep one."""
    assert list(inspect.signature(K.wgrad_plan).parameters) == [
        "rows", "c", "sm_count"]
    tp, tq = K.WGRAD_TILE
    for i, (per_frame, c) in enumerate(SWIN_ROWS_C):
        rows = frames * per_frame
        splits, per = K.wgrad_plan(rows, c, sms)
        assert (splits, per) == K.wgrad_plan(rows, c, sms)
        assert per % K.WGRAD_KB == 0
        assert (splits - 1) * per < rows <= splits * per
        tiles = (-(-3 * c // tp) + -(-c // tp)) * -(-c // tq)
        slots = K.WGRAD_BLOCKS_PER_SM * sms
        assert splits == 1 or splits * tiles <= slots
        workspace = splits * (4 * c * c + 4 * c) if splits > 1 else 0
        assert workspace <= slots * (tp * tq + tp)
        if i == 3:
            assert splits == 1
        if i == 0:
            assert splits * tiles > slots // 2 and splits >= 8


@pytest.mark.parametrize("rows", [1, 31, 32, 33, 127, 1000, 4097])
def test_wgrad_plan_covers_ragged_rows(rows):
    """Row counts off the k-block and tiny ones: one run when there are
    fewer than four k-blocks of rows, and the runs still cover every row
    once."""
    splits, per = K.wgrad_plan(rows, 96, 132)
    assert per % K.WGRAD_KB == 0 and (splits - 1) * per < rows <= splits * per
    if rows < 4 * K.WGRAD_KB:
        assert splits == 1


def test_wgrad_scheme_holds_the_f32_contract_at_swin_depth():
    """The weight-gradient kernel's arithmetic, emulated: A^T.B over the
    40,960 rows of stage 1 at b32 as three TF32 passes (hi = x & 0xffffe000,
    lo rounded to TF32) summed from zero every 8-row k-step, each k-step's
    sum added into f32 sums, over the plan's runs added in run order: within
    1e-5 of max|out| against float64, where one TF32 pass (hi.hi) misses by
    far."""
    rows, width = 40960, 16
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((rows, width)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((rows, width)).astype(np.float32))
    want = a.double().t() @ b.double()
    a_hi, b_hi, a_lo, b_lo = _tf32(a), _tf32(b), _tf32_lo(a), _tf32_lo(b)
    steps = [x.double().view(-1, 8, width) for x in (a_hi, a_lo, b_hi, b_lo)]
    ah, al, bh, bl = steps
    per_step = (torch.einsum("kri,krj->kij", ah, bl)
                + torch.einsum("kri,krj->kij", al, bh)
                + torch.einsum("kri,krj->kij", ah, bh)).float()
    splits, per = K.wgrad_plan(rows, 96, 132)
    total = torch.zeros(width, width)
    for s in range(splits):
        run = torch.zeros(width, width)
        for k in range(s * per // 8, min(rows, (s + 1) * per) // 8):
            run += per_step[k]
        total += run
    bound = 1e-5 * want.abs().max().item()
    assert (total.double() - want).abs().max().item() <= bound
    one = a_hi.double().t() @ b_hi.double()
    assert (one - want).abs().max().item() > 10 * bound


def test_k4_backward_kernels_are_reported():
    """K4 backward's two kernels are ``__global__`` functions of csrc/, on
    chip_smoke.py's tensor-core report (HMMA required) and in profiling.py's
    own columns, which no other column also counts."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    names = _global_kernels()
    for kern, group in (("wa_bwd_kernel", "k4_bwd_core"),
                        ("wa_wgrad_kernel", "k4_bwd_wgrad")):
        assert kern in names
        assert kern in chip_smoke.TENSOR_CORE_KERNELS
        assert kern in profiling.GROUPS[group]
    assert "wa_wgrad" in chip_smoke.K4_TRAIN_KERNELS
    for group, keys in profiling.GROUPS.items():
        for key in keys:
            for kern in ("wa_bwd_kernel", "wa_wgrad_kernel"):
                assert key == kern or key not in kern, (group, key)

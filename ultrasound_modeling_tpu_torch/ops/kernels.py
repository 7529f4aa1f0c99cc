"""Hand-written CUDA kernels of the serving and train paths, their plain
PyTorch versions, and launch counters.

Every Pallas kernel of the JAX package has its counterpart here (sources
in ``csrc/``, notes at the top of each file); every ``pallas_kernels.py``
line below is in ``ultrasound_modeling_tpu/ops/``:

* **K1** ``transformer_block`` — replaces ``transformer_block_fused``
  (``pallas_kernels.py:781``), the bf16 pre-LN block that bf16 serving
  runs once per layer.  Built from three kernels: ``layer_norm``,
  ``linear`` (``tb_linear``: the Hopper GEMM of ``csrc/gemm_sm90.cuh`` on
  bf16 operands, TMA-fed ``wgmma`` with a fused bias/GELU/residual
  epilogue) and ``attention_core`` (``csrc/transformer_block.cu``).
* **K4** ``window_attention`` — replaces ``window_attention_fused``
  (``pallas_kernels.py:83``; ``pl.pallas_call`` in
  ``_fused_attn_fwd_pallas`` ``:158``): the Swin's window attention, and
  the attention that f32 serving of the TransUNet and the ViT runs in every
  layer.  ``x`` is float32 or bfloat16, the weights float32, the products
  f32 and the output in x's dtype.  Built from ``linear`` (``wa_linear``:
  the same GEMM on f32 operands as 3xTF32 ``wgmma``, the f32 contract on
  the tensor cores; at the Swin's widths its narrow schedule, 128 x 96
  tiles on persistent blocks, chosen by :func:`linear_plan`, without the
  A_lo pass on an upcast bf16 x) and ``attention_core`` with an additive
  matrix (``csrc/window_attention.cu``: windows of at most 32 tokens on a
  warp per window and head, ``wa_window_fwd_kernel``).
  ``WindowAttentionFused`` adds the
  recompute backward (``_fused_attn_bwd`` ``:206``, XLA in the JAX
  package): qkv and ``g . proj_w`` on ``wa_linear``, the attention part
  (recomputed P, dq | dk | dv, the context and d_addmask) in one kernel,
  ``wa_attention_bwd`` (``csrc/window_attention_bwd.cu``, windows of at
  most 32 tokens), the weight and bias gradients in another, ``wa_wgrad``
  (``csrc/window_attention_wgrad.cu``, split over the rows) and dx on
  ``wa_linear``.
* **K2** ``group_flat_norm`` — replaces ``group_flat_norm``
  (``pallas_kernels.py:1113``; ``_gfn_fwd_pallas`` ``:1037`` and
  ``_gfn_bwd_pallas`` ``:1066``), the per-branch LayerNorm with the folded
  LeakyReLU that every split-attention stage runs twice on the train path.
  Forward ``group_flat_norm_fwd`` and backward ``group_flat_norm_bwd``
  (``csrc/group_flat_norm.cu``: a persistent grid walking 16-byte aligned
  row tiles through a bulk-copy ring), joined by ``GroupFlatNorm``.
  Where no gradient is taken (serving) ``group_flat_norm`` runs the forward
  kernel alone, the op ``ultrasound_port::group_flat_norm``
  (``group_flat_norm_eval``).
* **K3** ``flash_mha`` — replaces ``flash_mha`` (``pallas_kernels.py:655``;
  ``_flash_fwd_pallas`` ``:583`` and ``_flash_bwd_pallas`` ``:614``), the
  LSE-saving attention core of ``--attn-train flash``.  Forward
  ``flash_attention_fwd`` (context and per-row LSE) and backward
  ``flash_attention_bwd`` (packed dqkv) (``csrc/flash_attention.cu``),
  joined by ``FlashMHA``.
* **K5** ``attention_train_fused`` — replaces ``attention_train_fused``
  (``pallas_kernels.py:446``; ``pl.pallas_call`` in
  ``_attn_train_fwd_pallas`` ``:338``), the train attention of
  ``--attn-train pallas``: forward ``attention_train_fwd`` = ``linear`` +
  ``at_attention_core`` (float32 context; it also stores P and the qkv copy
  the backward reads, ``csrc/attention_train.cu``) + the f32 ``linear``
  (``wa_linear``) of the output projection; the backward is PyTorch
  in ``AttentionTrainFused``, as it is XLA in the JAX package (``:379-430``).
* **K6** ``label2vec_smooth`` — replaces ``fused_label2vec_smooth``
  (``pallas_kernels.py:1157``, ``pl.pallas_call`` ``:1173``), one
  elementwise pass (``csrc/label2vec.cu``); standalone, as in the JAX
  package, where no path calls it.

Every wrapper checks device, dtype, shape and contiguity and allocates its
outputs.  For CUDA tensors it launches its kernel (or raises); for CPU
tensors it calls the plain version, which is the same function written
with PyTorch ops — the CPU tests hold those against the JAX package, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
The entries the models call pick between a kernel and its plain version
here alone: :func:`plain_versions` makes them run the plain one anywhere.
``LAUNCHES`` counts kernel launches per CUDA entry point and per K1/K4/K5
call; ``LAYOUT_COPIES`` counts the inputs K2 and K3 had to copy into the
contiguous layout their kernels read.  K1, K4 and K2's forward are custom
ops (``ultrasound_port::transformer_block``, ``::window_attention``,
``::group_flat_norm``), which ``torch.export`` keeps as nodes of an exported
program (``infer/export.py``).

The kernels build on first use, one ``nvcc`` per source, all started
together, into ``_build/`` (``build()``); nothing here touches CUDA at
import.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import types
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ultrasound_modeling_tpu_torch.ops import window_attn

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each source becomes one shared library; its C entry points and their
# argument types (pointers and the stream as c_void_p, never a bare int)
SOURCES = {
    "transformer_block.cu": {
        "tb_layer_norm": [_P, _I, _P, _P, _P, _I, _I, _I, _F, _P],
        "tb_linear": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
        "tb_attention_core": [_P, _P, _I, _I, _I, _I, _F, _P]},
    "window_attention.cu": {
        "wa_linear": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P],
        "wa_attention_core": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P]},
    "window_attention_bwd.cu": {
        "wa_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _F, _P]},
    "window_attention_wgrad.cu": {
        "wa_wgrad": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _P]},
    "group_flat_norm.cu": {
        "group_flat_norm_fwd": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                _I, _F, _P],
        "group_flat_norm_bwd": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _F, _I, _F, _P]},
    "flash_attention.cu": {
        "flash_attention_fwd": [_P, _I, _P, _P, _I, _I, _I, _I, _F, _P],
        "flash_attention_bwd": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _F,
                                _P]},
    "attention_train.cu": {
        "at_attention_core": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]},
    "label2vec.cu": {
        "label2vec_smooth": [_P, _P, _I, _I, _F, _F, _P]},
}

MAX_SEQ = 160    # attention_core / flash_attention limits (csrc/*.cu)
MAX_HEAD_DIM = 160
WINDOW_BWD_MAX_SEQ = 32  # wa_attention_bwd's window limit (head dim as above)
# its warps a block, one block an SM, by key tiles of 8 (csrc/
# window_attention_bwd.cu wb_warps: as many as two window buffers each fit)
WINDOW_BWD_WARPS = {1: 12, 2: 12, 3: 8, 4: 6}
# wa_attention_core runs its per-window kernel (wa_window_fwd_kernel) on
# windows of at most this many tokens, attention_fwd_kernel above
WINDOW_FWD_MAX_SEQ = 32
# the f32 GEMM's narrow schedule (csrc/gemm_sm90.cuh linear_narrow_kernel):
# its output tile and its persistent blocks an SM
NARROW_TILE = (128, 96)
NARROW_BLOCKS_PER_SM = 1
# K4 backward's weight-gradient kernel (csrc/window_attention_wgrad.cu):
# its output tile (rows of the stacked [4C, C] result, each part in whole
# tiles, and columns), the rows of a k-block, and the blocks an SM that
# wgrad_plan fills
WGRAD_TILE = (64, 96)
WGRAD_KB = 32
WGRAD_BLOCKS_PER_SM = 1

# launches per CUDA entry point (csrc/*.cu), plus one per call of the three
# ported TPU kernels, K1, K4 and K5, that run a sequence of entry points
# (K2's, K3's and K6's functions are one entry point each), plus one per
# call of K2's forward op (group_flat_norm: the eval norm), plus the
# launches of K4's two shape-chosen kernels within their entry points:
# wa_window_fwd (wa_attention_core's per-window kernel) and
# wa_linear_narrow (wa_linear's narrow schedule)
LAUNCHES = {"transformer_block": 0, "window_attention": 0,
            "group_flat_norm": 0, "attention_train": 0, "wa_window_fwd": 0,
            "wa_linear_narrow": 0,
            **{fn: 0 for fns in SOURCES.values() for fn in fns}}
# inputs that K2 / K3 received in a layout their kernels do not read and
# copied (a non-contiguous conv output or incoming gradient; for K2 also a
# view whose data is not 16-byte aligned)
LAYOUT_COPIES = {"group_flat_norm": 0, "flash_mha": 0}

_LIB: Optional[types.SimpleNamespace] = None
BUILD_LOG = ""


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAYOUT_COPIES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (CUDA_HOME or PATH)")


def build() -> types.SimpleNamespace:
    """Compile each ``csrc/*.cu`` source into its own shared library (once
    per content of ``csrc/``), running one ``nvcc`` per source in parallel,
    and bind every C entry point; returns them as attributes."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha1()
    for p in sorted(CSRC.iterdir()):
        digest.update(p.name.encode() + p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:12]
    libs = {src: BUILD_DIR / f"lib{Path(src).stem}_{tag}.so" for src in SOURCES}
    jobs = {}
    for src, lib_path in libs.items():
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            jobs[src] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    logs, failed = [], []
    for src, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        logs.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src} ({proc.returncode})")
        else:
            os.replace(tmp, libs[src])
    BUILD_LOG = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{BUILD_LOG}")
    fns = {}
    for src, entry_points in SOURCES.items():
        lib = ctypes.CDLL(str(libs[src]))
        for name, argtypes in entry_points.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    _LIB = types.SimpleNamespace(**fns)
    return _LIB


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


_SM_COUNT = {}


def _sm_count(dev: torch.device) -> int:
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SM_COUNT[dev]


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn.__name__} failed: cudaError {rc}")
    LAUNCHES[fn.__name__] += 1


def _on_cuda(*ts: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in ts if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs must all be on one CPU or CUDA device, "
                     f"got {sorted(kinds)}")


_PLAIN = False


@contextlib.contextmanager
def plain_versions(on: bool = True):
    """While active (and ``on``), in every thread, each kernel entry a
    model calls (``transformer_block``, ``window_attention_fused``,
    ``group_flat_norm``, ``flash_mha``, ``attention_train_fused``) runs its
    ``*_plain`` version on any device and launches nothing.  It exists to
    hold the kernels against their plain versions."""
    global _PLAIN
    old, _PLAIN = _PLAIN, _PLAIN or on
    try:
        yield
    finally:
        _PLAIN = old


def _grad_taken(*ts: Optional[torch.Tensor]) -> bool:
    """True where autograd records an op on ``ts``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _check(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


_BF16 = torch.bfloat16
_F32 = torch.float32
_RES_KIND = {None: 0, _F32: 1, _BF16: 2}


# ---------------------------------------------------------------------------
# row LayerNorm
# ---------------------------------------------------------------------------

def layer_norm_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], w, b, eps).to(out_dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float,
               out_dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis of ``x [rows, C]`` (f32 statistics,
    centered variance); x and the output are float32 or bfloat16."""
    rows, c = x.shape
    _check(x, "x", (_F32, _BF16))
    _check(w, "w", (_F32,), (c,))
    _check(b, "b", (_F32,), (c,))
    if out_dtype not in (_F32, _BF16):
        raise TypeError(f"out_dtype {out_dtype} not float32/bfloat16")
    if not _on_cuda(x, w, b):
        return layer_norm_plain(x, w, b, eps, out_dtype)
    y = torch.empty((rows, c), dtype=out_dtype, device=x.device)
    _launch(build().tb_layer_norm, _ptr(x), int(x.dtype == _BF16),
            _ptr(w), _ptr(b), _ptr(y), int(out_dtype == _BF16), rows, c,
            float(eps), _stream())
    return y


# ---------------------------------------------------------------------------
# GEMM with fused epilogue
# ---------------------------------------------------------------------------

def linear_plain(a: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, gelu: bool = False,
                 residual: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = _F32,
                 a_tf32: bool = False) -> torch.Tensor:
    # bf16 operands upcast exactly, so this is f32 accumulation of the
    # exact products (with TF32 off on the card); a_tf32 changes nothing
    # here (see linear)
    y = a.float() @ w.float().t()
    if bias is not None:
        y = y + bias
    if gelu:
        y = F.gelu(y, approximate="none")
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def is_tf32(a: torch.Tensor) -> bool:
    """True when every value of the float32 ``a`` is exactly a TF32 value
    (its low 13 mantissa bits zero), as an upcast bfloat16 is."""
    return bool(((a.view(torch.int32) & 0x1FFF) == 0).all())


def linear_plan(m: int, n: int, k: int, dtype: torch.dtype, sm_count: int,
                a_tf32: bool = False) -> int:
    """The schedule of the f32 ``wgmma`` GEMM for an ``[m, k] x [n, k]^T``
    product: the persistent blocks of the narrow schedule (``NARROW_TILE``
    output tiles, at most ``NARROW_BLOCKS_PER_SM`` blocks an SM), or 0 for
    the 128 x 128 tile a block.  The narrow schedule takes K a whole
    multiple of 96 (the Swin's widths; bf16, and the TransUNet's, the
    ViT's and K5's K of 512 and 1280, keep the 128 x 128 tile) where it
    costs no more by this model: waves of tiles over the SMs, times the
    tile's width, times the passes over the tensor cores (3; 2 for the
    narrow schedule when ``a_tf32``).  It counts the 128 x 128 tile's
    padding at N = 96 .. 576 and the last wave's empty SMs, which decide
    the measured winner: at b64, the 128 x 128 tile keeps stage 3's
    projections and stage 4's qkv of an f32 x (a wave more as 96-wide
    tiles)."""
    bm, bn = NARROW_TILE
    if dtype != _F32 or k % bn:
        return 0
    m_tiles, slots = -(-m // bm), NARROW_BLOCKS_PER_SM * sm_count
    narrow = m_tiles * -(-n // bn)
    narrow_cost = -(-narrow // slots) * bn * (2 if a_tf32 else 3)
    wide_cost = -(-(m_tiles * -(-n // 128)) // sm_count) * 128 * 3
    return min(narrow, slots) if narrow_cost <= wide_cost else 0


def linear(a: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, gelu: bool = False,
           residual: Optional[torch.Tensor] = None,
           out_dtype: torch.dtype = _F32, a_tf32: bool = False) -> torch.Tensor:
    """``act(a @ w.T + bias) + residual`` with ``a [M, K]``, ``w [N, K]``
    (torch ``Linear`` layout) both bfloat16 (``tb_linear``) or both float32
    (``wa_linear``, 3xTF32: near-f32 products), f32 accumulation, on the
    ``wgmma`` GEMM of ``csrc/gemm_sm90.cuh`` (for float32 in the schedule
    :func:`linear_plan` picks); bias f32 ``[N]``; residual ``[M, N]`` f32
    or bf16; output f32 or bf16.  ``a_tf32``: the caller knows every value
    of the float32 ``a`` to be exactly TF32 (an upcast bf16), so the narrow
    schedule drops the A_lo pass, which would add exact zeros: the same
    bits (checked on CPU tensors, where it raises if ``a`` is not)."""
    m, k = a.shape
    n = w.shape[0]
    _check(a, "a", (_F32, _BF16))
    _check(w, "w", (a.dtype,), (n, k))
    if bias is not None:
        _check(bias, "bias", (_F32,), (n,))
    if residual is not None:
        _check(residual, "residual", (_F32, _BF16), (m, n))
    if out_dtype not in (_F32, _BF16):
        raise TypeError(f"out_dtype {out_dtype} not float32/bfloat16")
    if a_tf32 and a.dtype != _F32:
        raise TypeError("a_tf32 is a claim about a float32 a")
    if not _on_cuda(a, w, bias, residual):
        if a_tf32 and not is_tf32(a):
            raise ValueError("a_tf32: a has values below TF32 precision")
        return linear_plain(a, w, bias, gelu, residual, out_dtype)
    # TMA reads the operands: 16-byte aligned rows and base
    vec = 8 if a.dtype == _BF16 else 4
    if k % vec or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{a.dtype} linear needs K % {vec} == 0 and 16-byte "
                         f"aligned operands")
    lib = build()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    args = (_ptr(bias), _ptr(residual),
            _RES_KIND[None if residual is None else residual.dtype],
            _ptr(out), int(out_dtype == _BF16), m, n, k, int(gelu))
    if a.dtype == _BF16:
        _launch(lib.tb_linear, _ptr(a), _ptr(w), *args, _stream())
        return out
    grid = linear_plan(m, n, k, a.dtype, _sm_count(a.device), a_tf32)
    _launch(lib.wa_linear, _ptr(a), _ptr(w), *args, int(a_tf32), grid,
            _stream())
    if grid:
        LAUNCHES["wa_linear_narrow"] += 1
    return out


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def _check_attention_shape(rows: int, seq: int, c3: int, num_heads: int,
                           addmask: Optional[torch.Tensor]
                           ) -> Tuple[int, int, int]:
    """The attention core's limits; returns (sequences, C, head dim)."""
    c = c3 // 3
    if c3 % 3 or c % num_heads:
        raise ValueError(f"hidden {c} (qkv width {c3}) not divisible into "
                         f"{num_heads} heads")
    if rows % seq:
        raise ValueError(f"{rows} rows are not whole sequences of {seq}")
    d = c // num_heads
    if seq > MAX_SEQ or d > MAX_HEAD_DIM:
        raise ValueError(f"attention core takes seq <= {MAX_SEQ} and head "
                         f"dim <= {MAX_HEAD_DIM}, got {seq} and {d}")
    b = rows // seq
    if addmask is not None:
        nw = addmask.shape[0]
        _check(addmask, "addmask", (_F32,), (nw, num_heads, seq, seq))
        if b % nw:
            raise ValueError(f"{b} windows are not whole groups of {nw}")
    return b, c, d


def attention_core_plain(qkv: torch.Tensor, seq: int, num_heads: int,
                         scale: float, addmask: Optional[torch.Tensor] = None,
                         pv_bf16: bool = False,
                         out_dtype: torch.dtype = _F32) -> torch.Tensor:
    rows, c3 = qkv.shape
    b, c, d = rows // seq, c3 // 3, c3 // 3 // num_heads
    q, k, v = qkv.float().view(b, seq, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    s = (q * scale) @ k.transpose(-1, -2)                    # [b, h, S, S]
    if addmask is not None:
        nw = addmask.shape[0]
        s = (s.view(b // nw, nw, num_heads, seq, seq)
             + addmask[None]).view(b, num_heads, seq, seq)
    p = torch.softmax(s, dim=-1)
    if pv_bf16:
        p, v = p.to(_BF16).float(), v.to(_BF16).float()
    return (p @ v).transpose(1, 2).reshape(rows, c).to(out_dtype)


def attention_core(qkv: torch.Tensor, seq: int, num_heads: int, scale: float,
                   addmask: Optional[torch.Tensor] = None,
                   pv_bf16: bool = False,
                   out_dtype: torch.dtype = _F32) -> torch.Tensor:
    """Per (sequence, head) ``softmax(q*scale . k^T + addmask) . v`` over the
    packed f32 projection ``qkv [B*seq, 3C]`` (q | k | v, heads contiguous
    in each); sequence ``b`` adds ``addmask[b % nW]`` (``[nW, heads, seq,
    seq]``).  ``pv_bf16`` rounds P and V to bf16 before P.V (K1's contract).
    Returns the context ``[B*seq, C]``."""
    _check(qkv, "qkv", (_F32,))
    b, c, _ = _check_attention_shape(qkv.shape[0], seq, qkv.shape[1],
                                     num_heads, addmask)
    if not _on_cuda(qkv, addmask):
        return attention_core_plain(qkv, seq, num_heads, scale, addmask,
                                    pv_bf16, out_dtype)
    lib = build()
    out = torch.empty((qkv.shape[0], c), dtype=out_dtype, device=qkv.device)
    if pv_bf16 and addmask is None and out_dtype == _BF16:
        _launch(lib.tb_attention_core, _ptr(qkv), _ptr(out),
                b, seq, c, num_heads, float(scale), _stream())
    elif not pv_bf16 and out_dtype == _F32:
        nw = 1 if addmask is None else addmask.shape[0]
        _launch(lib.wa_attention_core, _ptr(qkv),
                _ptr(addmask), _ptr(out), b, seq, c, num_heads, nw,
                float(scale), _stream())
        if seq <= WINDOW_FWD_MAX_SEQ:
            LAUNCHES["wa_window_fwd"] += 1
    else:
        raise ValueError("the CUDA attention core takes (pv_bf16, no mask, "
                         "bf16 out) for K1 or (f32 P.V, f32 out) for K4")
    return out


# ---------------------------------------------------------------------------
# K1: bf16 transformer block
# ---------------------------------------------------------------------------

class BlockWeights(NamedTuple):
    """One pre-LN block's weights in the K1 contract: LN params and biases
    float32, matrices bfloat16 in ``Linear`` layout ``[out, in]``, q|k|v
    concatenated into ``qkv_w [3C, C]``."""
    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    qkv_w: torch.Tensor
    qkv_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    fc1_w: torch.Tensor
    fc1_b: torch.Tensor
    fc2_w: torch.Tensor
    fc2_b: torch.Tensor


def _block(x, w: BlockWeights, num_heads, scale, eps, final_ln, ln, lin, core):
    b, s, c = x.shape
    x2 = x.reshape(b * s, c)
    h = ln(x2, w.ln1_w, w.ln1_b, eps, _BF16)
    qkv = lin(h, w.qkv_w, w.qkv_b, out_dtype=_F32)
    ctx = core(qkv, s, num_heads, scale, pv_bf16=True, out_dtype=_BF16)
    x1 = lin(ctx, w.proj_w, w.proj_b, residual=x2, out_dtype=_F32)
    h2 = ln(x1, w.ln2_w, w.ln2_b, eps, _BF16)
    m = lin(h2, w.fc1_w, w.fc1_b, gelu=True, out_dtype=_BF16)
    if final_ln is None:
        out = lin(m, w.fc2_w, w.fc2_b, residual=x1, out_dtype=_BF16)
    else:
        out = lin(m, w.fc2_w, w.fc2_b, residual=x1, out_dtype=_F32)
        out = ln(out, final_ln[0], final_ln[1], eps, _BF16)
    return out.reshape(b, s, c)


def transformer_block_plain(x: torch.Tensor, w: BlockWeights, num_heads: int,
                            scale: float, eps: float,
                            final_ln: Optional[Tuple[torch.Tensor, torch.Tensor]]
                            = None) -> torch.Tensor:
    return _block(x, w, num_heads, scale, eps, final_ln, layer_norm_plain,
                  linear_plain, attention_core_plain)


def _final_ln(w: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    return None if w is None else (w, b)


class _NoGradient(torch.autograd.Function):
    """A forward-only op's output, tied to its inputs that require grad, so
    that a backward through it raises: the ops register no gradient, and
    autograd's fallback for such an op gives wrong gradients without an
    error."""

    @staticmethod
    def forward(ctx, name, out, *inputs):
        ctx.name = name
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(f"{ctx.name} is a forward op with no gradient; "
                           f"train through window_attention_fused, "
                           f"group_flat_norm or the train attention routes")


def _forward_op(name: str, *args):
    """``torch.ops.ultrasound_port.<name>`` on ``args``; where a gradient
    is being taken, its result raises on a backward (:class:`_NoGradient`)."""
    op = getattr(torch.ops.ultrasound_port, name).default
    if not torch.is_grad_enabled():
        return op(*args)
    tensors = [t for a in args for t in (a if isinstance(a, list) else [a])
               if isinstance(t, torch.Tensor) and t.requires_grad]
    if not tensors:
        return op(*args)
    with torch.no_grad():
        out = op(*args)
    return _NoGradient.apply(name, out, *tensors)


# K1 and K4's forward (and K2's, below) are ops of the ``ultrasound_port``
# namespace (torch.library), so that torch.export traces each call as one
# node and an exported program launches the kernels as the eager forward
# does: the CPU implementation is the plain version, the CUDA one the
# kernels (it counts its launches, also when an exported program calls
# it), and the fake one gives shape and dtype only.  They are defined by
# schema and called as ``torch.ops.ultrasound_port.*.default``, which costs
# the dispatcher alone (``torch.library.custom_op`` adds a Python wrapper
# to every call).  Their arguments are tensors, lists of tensors and
# scalars: BlockWeights travels as a list.
_OPS = torch.library.Library("ultrasound_port", "DEF")
_OPS.define("transformer_block(Tensor x, Tensor[] weights, int num_heads, "
            "float scale, float eps, Tensor? final_ln_w, Tensor? final_ln_b) "
            "-> Tensor")
_OPS.define("window_attention(Tensor x, Tensor qkv_w, Tensor? qkv_b, "
            "Tensor proj_w, Tensor? proj_b, int num_heads, Tensor? addmask, "
            "float scale) -> Tensor")


def _transformer_block_cpu(x, weights, num_heads, scale, eps, final_ln_w,
                           final_ln_b):
    return transformer_block_plain(x, BlockWeights(*weights), num_heads, scale,
                                   eps, _final_ln(final_ln_w, final_ln_b))


def _transformer_block_cuda(x, weights, num_heads, scale, eps, final_ln_w,
                            final_ln_b):
    LAUNCHES["transformer_block"] += 1
    return _block(x, BlockWeights(*weights), num_heads, scale, eps,
                  _final_ln(final_ln_w, final_ln_b), layer_norm, linear,
                  attention_core)


@torch.library.register_fake("ultrasound_port::transformer_block", lib=_OPS)
def _transformer_block_fake(x, weights, num_heads, scale, eps, final_ln_w,
                            final_ln_b):
    return torch.empty_like(x)


_OPS.impl("transformer_block", _transformer_block_cpu, "CPU")
_OPS.impl("transformer_block", _transformer_block_cuda, "CUDA")


def transformer_block(x: torch.Tensor, w: BlockWeights, num_heads: int,
                      scale: float, eps: float,
                      final_ln: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> torch.Tensor:
    """K1: one bf16 pre-LN block ``x [B, S, C]`` bf16 -> bf16, with the
    stack's trailing LayerNorm folded in when ``final_ln = (w, b)``; the
    op ``ultrasound_port::transformer_block``."""
    if _PLAIN:
        return transformer_block_plain(x, w, num_heads, scale, eps, final_ln)
    b, s, c = x.shape
    _check(x, "x", (_BF16,))
    _check_attention_shape(b * s, s, 3 * c, num_heads, None)
    for name, t in w._asdict().items():
        want = _BF16 if name.endswith("_w") and not name.startswith("ln") else _F32
        _check(t, name, (want,))
    fw, fb = final_ln if final_ln is not None else (None, None)
    _on_cuda(x, *w, fw, fb)            # raises on a mix of devices
    return _forward_op("transformer_block", x, list(w), num_heads,
                       float(scale), float(eps), fw, fb)


# ---------------------------------------------------------------------------
# K4: window attention, f32 products on an f32 or bf16 input
# ---------------------------------------------------------------------------

def window_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                           bias_table=None, rel_index=None, mask=None,
                           scale=None) -> torch.Tensor:
    """The plain version of :func:`window_attention`, differentiable by
    autograd (the plain route of :func:`window_attention_fused`)."""
    ctx = window_attn.window_attention(x.float(), qkv_w, qkv_b, bias_table,
                                       rel_index, num_heads, mask, scale)
    return linear_plain(ctx.reshape(-1, x.shape[-1]), proj_w, proj_b,
                        out_dtype=x.dtype).reshape(x.shape)


def _window_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, addmask,
                      scale, lin, core):
    # a bf16 x upcasts exactly (so the qkv product may drop its A_lo pass);
    # qkv, P and the context stay f32 and the projection's f32 sums round
    # once to x's dtype (pallas_kernels.py:62-79)
    nbw, n, c = x.shape
    qkv = lin(x.reshape(nbw * n, c).float(), qkv_w, qkv_b,
              a_tf32=x.dtype == _BF16)
    ctx = core(qkv, n, num_heads, scale, addmask=addmask)
    return lin(ctx, proj_w, proj_b, out_dtype=x.dtype).reshape(nbw, n, c)


def window_attention_fwd(x: torch.Tensor, qkv_w: torch.Tensor,
                         qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
                         proj_b: Optional[torch.Tensor], num_heads: int,
                         addmask: Optional[torch.Tensor],
                         scale: Optional[float] = None) -> torch.Tensor:
    """K4 forward with its additive matrix given (``window_attn.
    additive_matrix``: ``[nW, heads, N, N]`` float32, window ``b`` adds
    ``addmask[b % nW]``); arguments and result as :func:`window_attention`;
    the op ``ultrasound_port::window_attention``."""
    nbw, n, c = x.shape
    _check(x, "x", (_F32, _BF16))
    _check(qkv_w, "qkv_w", (_F32,), (3 * c, c))
    _check(proj_w, "proj_w", (_F32,), (c, c))
    for name, b, width in (("qkv_b", qkv_b, 3 * c), ("proj_b", proj_b, c)):
        if b is not None:
            _check(b, name, (_F32,), (width,))
    _check_attention_shape(nbw * n, n, 3 * c, num_heads, addmask)
    scale = float((c // num_heads) ** -0.5 if scale is None else scale)
    _on_cuda(x, qkv_w, qkv_b, proj_w, proj_b, addmask)  # raises on a mix
    return _forward_op("window_attention", x, qkv_w, qkv_b, proj_w, proj_b,
                       num_heads, addmask, scale)


def _window_attention_cpu(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                          addmask, scale):
    return _window_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                             addmask, scale, linear_plain, attention_core_plain)


def _window_attention_cuda(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                           addmask, scale):
    LAUNCHES["window_attention"] += 1
    return _window_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                             addmask, scale, linear, attention_core)


@torch.library.register_fake("ultrasound_port::window_attention", lib=_OPS)
def _window_attention_fake(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                           addmask, scale):
    return torch.empty_like(x)


_OPS.impl("window_attention", _window_attention_cpu, "CPU")
_OPS.impl("window_attention", _window_attention_cuda, "CUDA")


def window_attention(x: torch.Tensor, qkv_w: torch.Tensor,
                     qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
                     proj_b: Optional[torch.Tensor], num_heads: int,
                     bias_table: Optional[torch.Tensor] = None,
                     rel_index: Optional[torch.Tensor] = None,
                     mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """K4: fused window MSA forward.  ``x [nBW, N, C]`` float32 or
    bfloat16; ``qkv_w [3C, C]``, ``proj_w [C, C]`` (``Linear`` layout) and
    the biases float32; optional relative-position ``bias_table
    [(2wh-1)(2ww-1), heads]`` gathered through ``rel_index [N, N]``,
    optional shifted-window ``mask [nW, N, N]``; ``scale`` defaults to
    ``d**-0.5``.  qkv, the probabilities and the context are float32 and
    both projections f32 products; returns the projected output ``[nBW, N,
    C]`` in x's dtype."""
    addmask = window_attn.additive_matrix(num_heads, x.shape[1], bias_table,
                                          rel_index, mask)
    return window_attention_fwd(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                                addmask, scale)


def window_attention_bwd_plain(x, qkv_w, qkv_b, proj_w, addmask, g,
                               num_heads, scale):
    """K4's backward (``_fused_attn_bwd``, ``pallas_kernels.py:206-235``)
    from the saved inputs and the output gradient ``g``: qkv, the scores
    ``scale * q.k^T + addmask``, P and the context recomputed in float32,
    then ``(dx, d_qkv_w, d_qkv_b, d_proj_w, d_proj_b, d_addmask)``: dx in
    x's dtype, the rest float32; ``d_addmask [nW, heads, N, N]`` sums dS
    over the windows that share a mask variant.  PyTorch products (f32
    under ``full_f32_matmuls``), as the JAX backward is XLA."""
    nbw, n, c = x.shape
    d = c // num_heads
    x2 = x.reshape(nbw * n, c).float()
    qkv = x2 @ qkv_w.t()
    if qkv_b is not None:
        qkv = qkv + qkv_b
    q, k, v = qkv.view(nbw, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    s = scale * (q @ k.transpose(-1, -2))                   # [nBW, h, N, N]
    nw = 1 if addmask is None else addmask.shape[0]
    if addmask is not None:
        s = (s.view(nbw // nw, nw, num_heads, n, n) + addmask).view(s.shape)
    p = torch.softmax(s, dim=-1)
    o = (p @ v).transpose(1, 2).reshape(nbw * n, c)
    g2 = g.reshape(nbw * n, c).float()
    d_proj_w = g2.t() @ o
    d_proj_b = g2.sum(0)
    do = (g2 @ proj_w).view(nbw, n, num_heads, d).transpose(1, 2)
    dp = do @ v.transpose(-1, -2)
    dv = p.transpose(-1, -2) @ do
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    d_addmask = (None if addmask is None else
                 ds.view(nbw // nw, nw, num_heads, n, n).sum(0))
    dq = scale * (ds @ k)
    dk = scale * (ds.transpose(-1, -2) @ q)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(nbw * n,
                                                                    3 * c)
    d_qkv_b = None if qkv_b is None else dqkv.sum(0)
    dx = (dqkv @ qkv_w).to(x.dtype).view(x.shape)
    return dx, dqkv.t() @ x2, d_qkv_b, d_proj_w, d_proj_b, d_addmask


def check_window_bwd_shape(n: int, head_dim: int) -> None:
    """The limits of K4's backward kernel (``csrc/window_attention_bwd.cu``):
    windows of at most ``WINDOW_BWD_MAX_SEQ`` tokens, head dim at most
    ``MAX_HEAD_DIM``."""
    if n > WINDOW_BWD_MAX_SEQ or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"K4's backward kernel takes windows of at most "
                         f"{WINDOW_BWD_MAX_SEQ} tokens and head dim <= "
                         f"{MAX_HEAD_DIM}, got {n} and {head_dim}")


def window_bwd_plan(nbw: int, n: int, nw: int, num_heads: int,
                    sm_count: int) -> int:
    """Windows ``per`` warp of K4's backward kernel: each warp walks the
    windows of one (variant, head) with the next one's loads in flight, so
    the warps (window slices x variants x heads) come as close to one wave
    of the card's resident warps (``WINDOW_BWD_WARPS`` an SM) as whole
    slices allow, and the partial sums of d_addmask are one [N, N] a warp.
    It depends on the shape and the card alone, so d_addmask adds in one
    order."""
    reps = nbw // nw
    resident = WINDOW_BWD_WARPS[-(-n // 8)] * sm_count
    slices = max(1, min(reps, resident // (nw * num_heads)))
    return -(-reps // slices)


def window_attention_bwd_core_plain(qkv: torch.Tensor, do: torch.Tensor,
                                    addmask: Optional[torch.Tensor], n: int,
                                    num_heads: int, scale: float
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               Optional[torch.Tensor]]:
    rows, c3 = qkv.shape
    nbw, c, d = rows // n, c3 // 3, c3 // 3 // num_heads
    q, k, v = qkv.view(nbw, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    s = scale * (q @ k.transpose(-1, -2))                   # [nBW, h, N, N]
    nw = 1 if addmask is None else addmask.shape[0]
    if addmask is not None:
        s = (s.view(nbw // nw, nw, num_heads, n, n) + addmask).view(s.shape)
    p = torch.softmax(s, dim=-1)
    o = (p @ v).transpose(1, 2).reshape(rows, c)
    do4 = do.view(nbw, n, num_heads, d).transpose(1, 2)
    dp = do4 @ v.transpose(-1, -2)
    dv = p.transpose(-1, -2) @ do4
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    d_addmask = (None if addmask is None else
                 ds.view(nbw // nw, nw, num_heads, n, n).sum(0))
    dq = scale * (ds @ k)
    dk = scale * (ds.transpose(-1, -2) @ q)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(rows, c3)
    return dqkv, o, d_addmask


def window_attention_bwd_core(qkv: torch.Tensor, do: torch.Tensor,
                              addmask: Optional[torch.Tensor], n: int,
                              num_heads: int, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         Optional[torch.Tensor]]:
    """The attention part of K4's backward (``wa_attention_bwd``) on the
    float32 projection ``qkv [nBW*N, 3C]`` (q | k | v, heads contiguous in
    each) and ``do = g . proj_w`` ``[nBW*N, C]``: per (window, head) P =
    softmax(scale q.k^T + addmask[b % nW, h]) recomputed, then ``(dqkv
    [nBW*N, 3C], o [nBW*N, C], d_addmask [nW, heads, N, N] or None)``, all
    float32: dq | dk | dv, the context P.v and dS summed over the windows
    that share a variant (in a fixed order)."""
    _check(qkv, "qkv", (_F32,))
    rows, c3 = qkv.shape
    nbw, c, d = _check_attention_shape(rows, n, c3, num_heads, addmask)
    _check(do, "do", (_F32,), (rows, c))
    if not _on_cuda(qkv, do, addmask):
        return window_attention_bwd_core_plain(qkv, do, addmask, n, num_heads,
                                               scale)
    check_window_bwd_shape(n, d)
    dev = qkv.device
    nw = 1 if addmask is None else addmask.shape[0]
    per = window_bwd_plan(nbw, n, nw, num_heads, _sm_count(dev))
    dqkv = torch.empty_like(qkv)
    o = torch.empty((rows, c), dtype=_F32, device=dev)
    partial = d_addmask = None
    if addmask is not None:
        slices = -(-(nbw // nw) // per)
        partial = torch.empty((slices, nw, num_heads, n, n), dtype=_F32,
                              device=dev)
        d_addmask = torch.empty_like(addmask)
    _launch(build().wa_attention_bwd, _ptr(qkv), _ptr(do), _ptr(addmask),
            _ptr(dqkv), _ptr(o), _ptr(partial), _ptr(d_addmask), nbw, n, c,
            num_heads, nw, per, float(scale), _stream())
    return dqkv, o, d_addmask


def window_attention_wgrad_plain(dqkv: torch.Tensor, x2: torch.Tensor,
                                 g2: torch.Tensor, o: torch.Tensor,
                                 x_tf32: bool = False, g_tf32: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor, torch.Tensor]:
    # f32 products (TF32 off on the card); the claims change nothing here
    return dqkv.t() @ x2, dqkv.sum(0), g2.t() @ o, g2.sum(0)


def wgrad_plan(rows: int, c: int, sm_count: int) -> Tuple[int, int]:
    """``(splits, per)`` of K4 backward's weight-gradient kernel: its rows
    in runs of ``per`` (whole ``WGRAD_KB``-row k-blocks; the last run
    short), enough that the blocks, one per (``WGRAD_TILE`` tile of the
    stacked ``[4C, C]`` output, run), fill about ``WGRAD_BLOCKS_PER_SM`` an
    SM, and none shorter than four k-blocks.  It depends on the shape and
    the card alone, so the runs' partial sums add in one order; a shape
    whose tiles alone fill the card takes one run (the Swin's stage 4), and
    the partial sums never outgrow one tile a block."""
    tp, tq = WGRAD_TILE
    tiles = (-(-3 * c // tp) + -(-c // tp)) * -(-c // tq)
    splits = max(1, min(WGRAD_BLOCKS_PER_SM * sm_count // tiles,
                        rows // (4 * WGRAD_KB)))
    per = -(-(-(-rows // splits)) // WGRAD_KB) * WGRAD_KB
    return -(-rows // per), per


def window_attention_wgrad(dqkv: torch.Tensor, x2: torch.Tensor,
                           g2: torch.Tensor, o: torch.Tensor,
                           x_tf32: bool = False, g_tf32: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """The weight and bias gradients of K4's backward (``wa_wgrad``) from
    the attention kernel's ``dqkv [rows, 3C]`` and context ``o [rows, C]``,
    the forward's input ``x2`` and the output gradient ``g2`` (``[rows,
    C]``), all float32: ``(d_qkv_w = dqkv^T.x2 [3C, C], d_qkv_b = sum of
    dqkv's rows [3C], d_proj_w = g2^T.o [C, C], d_proj_b = sum of g2's rows
    [C])``, the products held to the f32 contract, in one launch (and a
    fixed-order reduce of the row runs, :func:`wgrad_plan`).  ``x_tf32`` /
    ``g_tf32``: the caller knows every value of x2 / g2 to be exactly TF32
    (an upcast bf16), so that product drops its lo pass, which would add
    exact zeros: the same bits (checked on CPU tensors, where it raises if
    one is not)."""
    _check(dqkv, "dqkv", (_F32,))
    rows, c3 = dqkv.shape
    c = c3 // 3
    if c3 % 3:
        raise ValueError(f"dqkv width {c3} is not 3C")
    for name, t in (("x2", x2), ("g2", g2), ("o", o)):
        _check(t, name, (_F32,), (rows, c))
    if not _on_cuda(dqkv, x2, g2, o):
        for name, t, claim in (("x2", x2, x_tf32), ("g2", g2, g_tf32)):
            if claim and not is_tf32(t):
                raise ValueError(f"{name}: values below TF32 precision")
        return window_attention_wgrad_plain(dqkv, x2, g2, o)
    # 16-byte copies read the rows: C % 4 == 0 and 16-byte aligned bases
    if c % 4 or any(t.data_ptr() % 16 for t in (dqkv, x2, g2, o)):
        raise ValueError("wa_wgrad needs C % 4 == 0 and 16-byte aligned "
                         "operands")
    dev = dqkv.device
    splits, per = wgrad_plan(rows, c, _sm_count(dev))
    d_qkv_w = torch.empty((c3, c), dtype=_F32, device=dev)
    d_qkv_b = torch.empty((c3,), dtype=_F32, device=dev)
    d_proj_w = torch.empty((c, c), dtype=_F32, device=dev)
    d_proj_b = torch.empty((c,), dtype=_F32, device=dev)
    partial = (torch.empty((splits, 4 * c * c + 4 * c), dtype=_F32,
                           device=dev) if splits > 1 else None)
    _launch(build().wa_wgrad, _ptr(dqkv), _ptr(x2), _ptr(g2), _ptr(o),
            _ptr(d_qkv_w), _ptr(d_qkv_b), _ptr(d_proj_w), _ptr(d_proj_b),
            _ptr(partial), rows, c, splits, per, int(x_tf32), int(g_tf32),
            _stream())
    return d_qkv_w, d_qkv_b, d_proj_w, d_proj_b


def _window_attention_bwd(x, qkv_w, qkv_b, proj_w, addmask, g, num_heads,
                          scale, lin, core, wgrad):
    # a bf16 x (and its bf16 g) upcast exactly, so (a), (b) and (d) may
    # drop their lo pass of it; every product is f32
    nbw, n, c = x.shape
    x_tf32, g_tf32 = x.dtype == _BF16, g.dtype == _BF16
    x2 = x.reshape(nbw * n, c).float()
    g2 = g.reshape(nbw * n, c).float().contiguous()
    qkv = lin(x2, qkv_w, qkv_b, a_tf32=x_tf32)                     # a
    do = lin(g2, proj_w.t().contiguous(), a_tf32=g_tf32)            # b
    dqkv, o, d_addmask = core(qkv, do, addmask, n, num_heads, scale)  # c
    del qkv, do              # freed here, the peak is the core's call
    d_qkv_w, d_qkv_b, d_proj_w, d_proj_b = wgrad(                  # d
        dqkv, x2, g2, o, x_tf32=x_tf32, g_tf32=g_tf32)
    del o
    dx = lin(dqkv, qkv_w.t().contiguous(), out_dtype=x.dtype)      # e
    return (dx.view(x.shape), d_qkv_w, None if qkv_b is None else d_qkv_b,
            d_proj_w, d_proj_b, d_addmask)


def window_attention_bwd(x, qkv_w, qkv_b, proj_w, addmask, g, num_heads,
                         scale):
    """K4's backward, arguments and results as
    :func:`window_attention_bwd_plain`.  On the card: (a) qkv = x.qkv_w^T +
    qkv_b and (b) do = g.proj_w on ``wa_linear``, (c) the attention part in
    one kernel (:func:`window_attention_bwd_core`), (d) the weight and bias
    gradients in another (:func:`window_attention_wgrad`), (e) dx =
    dqkv.qkv_w on ``wa_linear``, stored in x's dtype.  (b) and (e) read a
    transposed copy of their weight (``wa_linear`` takes ``[N, K]``).
    Raises above the kernel's limits (:func:`check_window_bwd_shape`)."""
    if not _on_cuda(x, qkv_w, qkv_b, proj_w, addmask, g):
        return window_attention_bwd_plain(x, qkv_w, qkv_b, proj_w, addmask, g,
                                          num_heads, scale)
    check_window_bwd_shape(x.shape[1], x.shape[2] // num_heads)
    return _window_attention_bwd(x, qkv_w, qkv_b, proj_w, addmask, g,
                                 num_heads, scale, linear,
                                 window_attention_bwd_core,
                                 window_attention_wgrad)


class WindowAttentionFused(torch.autograd.Function):
    """K4 with its recompute backward (``_fused_attn_core``'s custom VJP):
    the forward (the kernel's wrapper) saves only its inputs; the backward
    (:func:`window_attention_bwd`) recomputes qkv, P and the context and
    runs its attention part as one kernel on the card."""

    @staticmethod
    def forward(ctx, x, qkv_w, qkv_b, proj_w, proj_b, addmask, num_heads,
                scale):
        ctx.attn = (num_heads, scale)
        ctx.save_for_backward(x, qkv_w, qkv_b, proj_w, addmask)
        return window_attention_fwd(x, qkv_w, qkv_b, proj_w, proj_b,
                                    num_heads, addmask, scale)

    @staticmethod
    def backward(ctx, g):
        x, qkv_w, qkv_b, proj_w, addmask = ctx.saved_tensors
        grads = window_attention_bwd(x, qkv_w, qkv_b, proj_w, addmask, g,
                                     *ctx.attn)
        return (*(d if need else None
                  for d, need in zip(grads, ctx.needs_input_grad)), None, None)


def window_attention_fused(x: torch.Tensor, qkv_w: torch.Tensor,
                           qkv_b: Optional[torch.Tensor], proj_w: torch.Tensor,
                           proj_b: Optional[torch.Tensor], num_heads: int,
                           bias_table: Optional[torch.Tensor] = None,
                           rel_index: Optional[torch.Tensor] = None,
                           mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """K4 with :func:`window_attention`'s contract (``pallas_kernels.
    window_attention_fused``): where a gradient is taken
    ``WindowAttentionFused``, with gradients to x, both projections and
    their biases, and through the additive matrix's gather to the bias
    table; where none is, the forward op alone."""
    x = x.contiguous()
    if _PLAIN:
        return window_attention_plain(x, qkv_w, qkv_b, proj_w, proj_b,
                                      num_heads, bias_table, rel_index, mask,
                                      scale)
    addmask = window_attn.additive_matrix(num_heads, x.shape[1], bias_table,
                                          rel_index, mask)
    if scale is None:
        scale = (x.shape[-1] // num_heads) ** -0.5
    if not _grad_taken(x, qkv_w, qkv_b, proj_w, proj_b, addmask):
        return window_attention_fwd(x, qkv_w, qkv_b, proj_w, proj_b,
                                    num_heads, addmask, float(scale))
    return WindowAttentionFused.apply(x, qkv_w, qkv_b, proj_w, proj_b,
                                      addmask, num_heads, float(scale))


# ---------------------------------------------------------------------------
# K2: per-group channel LayerNorm over a flat channel axis (+ LeakyReLU)
# ---------------------------------------------------------------------------

# bytes of a K2 row tile: of y in the forward, of y and of g each in the
# backward (csrc/group_flat_norm.cu keeps two of them in flight a block)
GFN_TILE_BYTES = {"fwd": 16384, "bwd": 8192}


def gfn_plan(rows: int, f: int, elem: int, direction: str,
             max_blocks: int) -> Tuple[int, int]:
    """``(R, grid)`` of a K2 launch: tiles of R rows, R a multiple of the
    rows that make 16 bytes and about ``GFN_TILE_BYTES`` of a tile, over at
    most ``max_blocks`` blocks, sized so that every block walks the same
    number of tiles, give or take one.  The plan depends on the shape and
    the card alone, so the backward's column sums add in one order."""
    step = 16 // math.gcd(f * elem, 16)
    rmax = max(step, GFN_TILE_BYTES[direction] // (f * elem) // step * step)
    per_block = -(-(-(-rows // rmax)) // max_blocks)
    r = -(-(-(-rows // (max_blocks * per_block))) // step) * step
    return r, min(-(-rows // r), max_blocks)


def _gfn_launch_plan(y2: torch.Tensor, direction: str) -> Tuple[int, int]:
    """The plan on y2's card: at most two blocks an SM."""
    rows, f = y2.shape
    return gfn_plan(rows, f, y2.element_size(), direction,
                    2 * _sm_count(y2.device))


def _check_gfn(y2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               gsize: int) -> None:
    _check(y2, "y", (_F32, _BF16))
    if y2.dim() != 2:
        raise ValueError(f"y must be [rows, F], got {tuple(y2.shape)}")
    f = y2.shape[1]
    if gsize <= 0 or f % gsize:
        raise ValueError(f"channels {f} not divisible by group size {gsize}")
    _check(scale, "scale", (_F32,), (f,))
    _check(bias, "bias", (_F32,), (f,))


def _check_gfn_aligned(*ts: torch.Tensor) -> None:
    """The kernels bulk-copy 16-byte aligned row tiles."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("group_flat_norm's CUDA kernels take tensors whose "
                             "data starts 16-byte aligned")


def _gfn_groups(y2: torch.Tensor, gsize: int, eps: float):
    """(centered values, 1/std) per row and group, float32, two-pass."""
    rows, f = y2.shape
    yg = y2.float().reshape(rows, f // gsize, gsize)
    zc = yg - yg.mean(-1, keepdim=True)
    return zc, torch.rsqrt((zc * zc).mean(-1, keepdim=True) + eps)


def group_flat_norm_fwd_plain(y2: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, gsize: int, eps: float,
                              alpha: Optional[float] = None) -> torch.Tensor:
    zc, rstd = _gfn_groups(y2, gsize, eps)
    out = (zc * rstd).reshape(y2.shape) * scale + bias
    if alpha is not None:
        out = torch.where(out >= 0, out, alpha * out)
    return out.to(y2.dtype)


def group_flat_norm_bwd_plain(y2: torch.Tensor, g2: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              gsize: int, eps: float,
                              alpha: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    rows, f = y2.shape
    zc, rstd = _gfn_groups(y2, gsize, eps)
    xhat = (zc * rstd).reshape(rows, f)
    g = g2.float()
    if alpha is not None:
        g = g * torch.where(xhat * scale + bias >= 0, 1.0, alpha)
    sg = (g * scale).reshape(zc.shape)
    xg = xhat.reshape(zc.shape)
    t1 = sg.mean(-1, keepdim=True)
    t2 = (sg * xg).mean(-1, keepdim=True)
    dy = ((sg - t1 - xg * t2) * rstd).reshape(rows, f)
    return dy.to(y2.dtype), (g * xhat).sum(0), g.sum(0)


def group_flat_norm_fwd(y2: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, gsize: int, eps: float,
                        alpha: Optional[float] = None) -> torch.Tensor:
    """K2 forward: each contiguous group of ``gsize`` channels of every row
    of ``y2 [rows, F]`` (float32 or bfloat16) normalized with its own
    float32 mean and biased variance, then ``* scale + bias`` (float32
    ``[F]``) and, when ``alpha`` is given, LeakyReLU(alpha).  Output in
    y2's dtype."""
    _check_gfn(y2, scale, bias, gsize)
    if not _on_cuda(y2, scale, bias):
        return group_flat_norm_fwd_plain(y2, scale, bias, gsize, eps, alpha)
    _check_gfn_aligned(y2)
    rows, f = y2.shape
    out = torch.empty_like(y2)
    _launch(build().group_flat_norm_fwd, _ptr(y2), int(y2.dtype == _BF16),
            _ptr(scale), _ptr(bias), _ptr(out), rows, f, gsize,
            *_gfn_launch_plan(y2, "fwd"), float(eps), int(alpha is not None),
            float(alpha or 0.0), _stream())
    return out


def group_flat_norm_bwd(y2: torch.Tensor, g2: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor, gsize: int,
                        eps: float, alpha: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 backward from the saved input ``y2`` and the output gradient
    ``g2`` (y2's dtype): ``(dy, dscale, dbias)``, dy in y2's dtype, dscale
    and dbias float32 sums over all rows (per-block partials, then one
    fixed-order reduce: the same bits on every run)."""
    _check_gfn(y2, scale, bias, gsize)
    _check(g2, "g", (y2.dtype,), tuple(y2.shape))
    if not _on_cuda(y2, g2, scale, bias):
        return group_flat_norm_bwd_plain(y2, g2, scale, bias, gsize, eps,
                                         alpha)
    _check_gfn_aligned(y2, g2)
    rows, f = y2.shape
    r, grid = _gfn_launch_plan(y2, "bwd")
    dy = torch.empty_like(y2)
    partial = torch.empty((grid, 2, f), dtype=_F32, device=y2.device)
    dsb = torch.empty((2, f), dtype=_F32, device=y2.device)
    _launch(build().group_flat_norm_bwd, _ptr(y2), _ptr(g2),
            int(y2.dtype == _BF16), _ptr(scale), _ptr(bias), _ptr(dy),
            _ptr(partial), _ptr(dsb[0]), _ptr(dsb[1]), rows, f, gsize, r, grid,
            float(eps), int(alpha is not None), float(alpha or 0.0),
            _stream())
    return dy, dsb[0], dsb[1]


def _contiguous(t: torch.Tensor, kernel: str) -> torch.Tensor:
    if not t.is_contiguous():
        LAYOUT_COPIES[kernel] += 1
        t = t.contiguous()
    return t


def _gfn_layout(t: torch.Tensor) -> torch.Tensor:
    """K2's kernels read a contiguous tensor whose data starts 16-byte
    aligned; any other is copied once and counted."""
    if t.is_contiguous() and not (t.is_cuda and t.data_ptr() % 16):
        return t
    LAYOUT_COPIES["group_flat_norm"] += 1
    return t.clone(memory_format=torch.contiguous_format)


class GroupFlatNorm(torch.autograd.Function):
    """K2 with its backward kernel: saves the input, recomputes the group
    statistics in the backward (as ``_gfn_core``'s custom VJP does)."""

    @staticmethod
    def forward(ctx, y2, scale, bias, gsize, eps, alpha):
        ctx.gfn = (gsize, eps, alpha)
        ctx.save_for_backward(y2, scale, bias)
        return group_flat_norm_fwd(y2, scale, bias, gsize, eps, alpha)

    @staticmethod
    def backward(ctx, g):
        y2, scale, bias = ctx.saved_tensors
        dy, dscale, dbias = group_flat_norm_bwd(
            y2, _gfn_layout(g).to(y2.dtype), scale, bias,
            *ctx.gfn)
        return dy, dscale, dbias, None, None, None


def _gfn_alpha(act: Optional[str], act_alpha: float) -> Optional[float]:
    if act not in (None, "leaky"):
        raise ValueError(f"unsupported folded activation {act!r}")
    return float(act_alpha) if act == "leaky" else None


# K2's forward alone as an op (see K1 and K4's above), for the eval norm.
# The wrapper makes y contiguous; the CUDA impl checks the kernel's 16-byte
# alignment on the real tensor (a traced one has no address).
_OPS.define("group_flat_norm(Tensor y, Tensor scale, Tensor bias, int gsize, "
            "float eps, float? alpha) -> Tensor")


def _group_flat_norm_cuda(y, scale, bias, gsize, eps, alpha):
    LAUNCHES["group_flat_norm"] += 1
    return group_flat_norm_fwd(_gfn_layout(y), scale, bias, gsize, eps, alpha)


@torch.library.register_fake("ultrasound_port::group_flat_norm", lib=_OPS)
def _group_flat_norm_fake(y, scale, bias, gsize, eps, alpha):
    return torch.empty_like(y)


_OPS.impl("group_flat_norm", group_flat_norm_fwd_plain, "CPU")
_OPS.impl("group_flat_norm", _group_flat_norm_cuda, "CUDA")


def group_flat_norm_eval(y: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, gsize: int, eps: float,
                         act: Optional[str] = None,
                         act_alpha: float = 0.3) -> torch.Tensor:
    """K2's forward with :func:`group_flat_norm`'s arguments, as the op
    ``ultrasound_port::group_flat_norm``: one kernel launch on the card, the
    plain version on the CPU; :func:`group_flat_norm` where no gradient is
    taken.  A backward through it raises.  A non-contiguous ``y`` is copied
    once and counted in ``LAYOUT_COPIES``."""
    alpha = _gfn_alpha(act, act_alpha)
    f = y.shape[-1]
    y2 = _contiguous(y, "group_flat_norm").view(-1, f)
    scale, bias = scale.reshape(-1), bias.reshape(-1)
    _check_gfn(y2, scale, bias, gsize)
    _on_cuda(y2, scale, bias)          # raises on a mix of devices
    return _forward_op("group_flat_norm", y2, scale, bias, int(gsize),
                       float(eps), alpha).view(y.shape)


def group_flat_norm(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    gsize: int, eps: float, act: Optional[str] = None,
                    act_alpha: float = 0.3) -> torch.Tensor:
    """K2 with the JAX signature (``pallas_kernels.group_flat_norm``): ``y
    [..., F]``, per-channel ``scale``/``bias`` of F values (any shape),
    ``act='leaky'`` folds LeakyReLU(``act_alpha``) in.  Where a gradient is
    taken ``GroupFlatNorm``; where none is, the forward op alone
    (:func:`group_flat_norm_eval`).  The kernels read ``y`` as a contiguous,
    16-byte aligned ``[rows, F]``; any other layout is copied once and
    counted in ``LAYOUT_COPIES``."""
    if _PLAIN:
        return group_flat_norm_plain(y, scale, bias, gsize, eps, act,
                                     act_alpha)
    if not _grad_taken(y, scale, bias):
        return group_flat_norm_eval(y, scale, bias, gsize, eps, act=act,
                                    act_alpha=act_alpha)
    alpha = _gfn_alpha(act, act_alpha)
    f = y.shape[-1]
    y2 = _gfn_layout(y).view(-1, f)
    out = GroupFlatNorm.apply(y2, scale.reshape(-1), bias.reshape(-1),
                              int(gsize), float(eps), alpha)
    return out.view(y.shape)


def group_flat_norm_plain(y: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, gsize: int, eps: float,
                          act: Optional[str] = None,
                          act_alpha: float = 0.3) -> torch.Tensor:
    """The plain route of :func:`group_flat_norm`: the same forward in
    PyTorch ops, differentiated by autograd (an independent check of the
    backward kernel)."""
    f = y.shape[-1]
    out = group_flat_norm_fwd_plain(y.reshape(-1, f), scale.reshape(-1),
                                    bias.reshape(-1), int(gsize), float(eps),
                                    _gfn_alpha(act, act_alpha))
    return out.reshape(y.shape)


# ---------------------------------------------------------------------------
# K3: flash-style attention core (LSE-saving), forward and backward
# ---------------------------------------------------------------------------

def _check_flash(qkv2: torch.Tensor, seq: int,
                 num_heads: int) -> Tuple[int, int, int]:
    _check(qkv2, "qkv", (_F32, _BF16))
    if qkv2.dim() != 2:
        raise ValueError(f"qkv must be [B*seq, 3C], got {tuple(qkv2.shape)}")
    return _check_attention_shape(qkv2.shape[0], seq, qkv2.shape[1],
                                  num_heads, None)


def _split_heads(qkv2: torch.Tensor, seq: int, num_heads: int):
    """float32 q, k, v ``[B, heads, seq, d]`` of a packed ``[B*seq, 3C]``."""
    rows, c3 = qkv2.shape
    d = c3 // 3 // num_heads
    return qkv2.float().view(rows // seq, seq, 3, num_heads, d).permute(
        2, 0, 3, 1, 4)


def flash_attention_fwd_plain(qkv2: torch.Tensor, seq: int, num_heads: int,
                              scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = qkv2.dtype
    q, k, v = _split_heads(qkv2, seq, num_heads)
    s = (q @ k.transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(-1, keepdim=True)
    p = (e / den).to(dt).float()
    ctx = (p @ v).transpose(1, 2).reshape(qkv2.shape[0], -1)
    return ctx.to(dt), (m + torch.log(den)).squeeze(-1)


def flash_attention_bwd_plain(qkv2: torch.Tensor, lse: torch.Tensor,
                              g2: torch.Tensor, seq: int, num_heads: int,
                              scale: float) -> torch.Tensor:
    dt = qkv2.dtype
    q, k, v = _split_heads(qkv2, seq, num_heads)
    b, h, _, d = q.shape
    g = g2.to(dt).float().view(b, seq, h, d).transpose(1, 2)
    p = torch.exp((q @ k.transpose(-1, -2)) * scale - lse[..., None])
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    ds = (ds * scale).to(dt).float()
    dqkv = torch.stack([ds @ k, ds.transpose(-1, -2) @ q,
                        p.to(dt).float().transpose(-1, -2) @ g])
    return dqkv.permute(1, 3, 0, 2, 4).reshape(qkv2.shape).to(dt)


def flash_attention_fwd(qkv2: torch.Tensor, seq: int, num_heads: int,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 forward on the packed projection ``qkv2 [B*seq, 3C]`` (q | k | v,
    heads contiguous in each; float32 or bfloat16): per (sequence, head)
    ``s = q.k^T * scale``, ``P = softmax(s)`` cast to qkv's dtype, context
    ``P.v`` ``[B*seq, C]`` in qkv's dtype and the float32 row log-sum-exp
    ``[B, heads, seq]``."""
    b, c, _ = _check_flash(qkv2, seq, num_heads)
    if not _on_cuda(qkv2):
        return flash_attention_fwd_plain(qkv2, seq, num_heads, scale)
    out = torch.empty((qkv2.shape[0], c), dtype=qkv2.dtype, device=qkv2.device)
    lse = torch.empty((b, num_heads, seq), dtype=_F32, device=qkv2.device)
    _launch(build().flash_attention_fwd, _ptr(qkv2), int(qkv2.dtype == _BF16),
            _ptr(out), _ptr(lse), b, seq, c, num_heads, float(scale),
            _stream())
    return out, lse


def flash_attention_bwd(qkv2: torch.Tensor, lse: torch.Tensor,
                        g2: torch.Tensor, seq: int, num_heads: int,
                        scale: float) -> torch.Tensor:
    """K3 backward: ``dqkv [B*seq, 3C]`` in qkv's dtype from the saved
    ``qkv2``, ``lse`` and the context gradient ``g2 [B*seq, C]`` (qkv's
    dtype).  P is recomputed as ``exp(s - lse)``; dS is cast to qkv's dtype
    before dq and dk, P before dv; sums are float32."""
    b, c, _ = _check_flash(qkv2, seq, num_heads)
    _check(lse, "lse", (_F32,), (b, num_heads, seq))
    _check(g2, "g", (qkv2.dtype,), (qkv2.shape[0], c))
    if not _on_cuda(qkv2, lse, g2):
        return flash_attention_bwd_plain(qkv2, lse, g2, seq, num_heads, scale)
    dqkv = torch.empty_like(qkv2)
    rowsum = torch.empty((b, num_heads, seq), dtype=_F32, device=qkv2.device)
    _launch(build().flash_attention_bwd, _ptr(qkv2), _ptr(lse), _ptr(g2),
            int(qkv2.dtype == _BF16), _ptr(dqkv), _ptr(rowsum), b, seq, c,
            num_heads, float(scale), _stream())
    return dqkv


class FlashMHA(torch.autograd.Function):
    """K3 with its backward kernel; saves only qkv and the row LSE (as
    ``_flash_core``'s custom VJP does)."""

    @staticmethod
    def forward(ctx, qkv2, seq, num_heads, scale):
        out, lse = flash_attention_fwd(qkv2, seq, num_heads, scale)
        ctx.attn = (seq, num_heads, scale)
        ctx.save_for_backward(qkv2, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv2, lse = ctx.saved_tensors
        g2 = _contiguous(g, "flash_mha").to(qkv2.dtype)
        return flash_attention_bwd(qkv2, lse, g2, *ctx.attn), None, None, None


def flash_mha(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Differentiable K3 with the JAX contract (``pallas_kernels.
    flash_mha``): packed ``qkv [B, N, 3C]`` -> context ``[B, N, C]`` in
    qkv's dtype, with an explicit score ``scale``."""
    if _PLAIN:
        return flash_mha_plain(qkv, num_heads, scale)
    b, n, c3 = qkv.shape
    qkv2 = _contiguous(qkv, "flash_mha").view(b * n, c3)
    return FlashMHA.apply(qkv2, n, num_heads, float(scale)).view(b, n, c3 // 3)


def flash_mha_plain(qkv: torch.Tensor, num_heads: int,
                    scale: float) -> torch.Tensor:
    """The plain route of :func:`flash_mha`: the forward's math and casts
    in PyTorch ops, differentiated by autograd."""
    b, n, c3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split_heads(qkv.reshape(b * n, c3), n, num_heads)
    p = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1).to(dt)
    ctx = (p.float() @ v).to(dt)
    return ctx.transpose(1, 2).reshape(b, n, c3 // 3)


# ---------------------------------------------------------------------------
# K5: train attention that saves its backward's inputs
# ---------------------------------------------------------------------------

def _check_attention_train(x2, qkv_w, qkv_b, proj_w, proj_b, seq, num_heads):
    _check(x2, "x", (_F32, _BF16))
    if x2.dim() != 2:
        raise ValueError(f"x must be [B*seq, C], got {tuple(x2.shape)}")
    c = x2.shape[1]
    _check(qkv_w, "qkv_w", (x2.dtype,), (3 * c, c))
    _check(qkv_b, "qkv_b", (_F32,), (3 * c,))
    _check(proj_w, "proj_w", (x2.dtype,), (c, c))
    _check(proj_b, "proj_b", (_F32,), (c,))
    _check_attention_shape(x2.shape[0], seq, 3 * c, num_heads, None)


def attention_train_core_plain(qkv: torch.Tensor, seq: int, num_heads: int,
                               scale: float, dtype: torch.dtype):
    q, k, v = _split_heads(qkv, seq, num_heads)
    p = torch.softmax((q * scale) @ k.transpose(-1, -2), dim=-1)
    ctx = (p @ v).transpose(1, 2).reshape(qkv.shape[0], -1)
    return ctx, qkv.to(dtype), p.to(dtype)


def attention_train_core(qkv: torch.Tensor, seq: int, num_heads: int,
                         scale: float, dtype: torch.dtype
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's attention core on the float32 projection ``qkv [B*seq, 3C]``:
    per (sequence, head) ``P = softmax(q*scale . k^T)`` in float32 and the
    context ``P.v``.  Returns ``(ctx [B*seq, C], qkv [B*seq, 3C], P [B,
    heads, seq, seq])``: the context in float32, the saved qkv and P in
    ``dtype`` (float32 or bfloat16); under float32 the returned qkv is the
    input itself."""
    _check(qkv, "qkv", (_F32,))
    if dtype not in (_F32, _BF16):
        raise TypeError(f"dtype {dtype} not float32/bfloat16")
    b, c, _ = _check_attention_shape(qkv.shape[0], seq, qkv.shape[1],
                                     num_heads, None)
    if not _on_cuda(qkv):
        return attention_train_core_plain(qkv, seq, num_heads, scale, dtype)
    rows, dev = qkv.shape[0], qkv.device
    ctx = torch.empty((rows, c), dtype=_F32, device=dev)
    p = torch.empty((b, num_heads, seq, seq), dtype=dtype, device=dev)
    saved = qkv if dtype == _F32 else torch.empty((rows, 3 * c), dtype=dtype,
                                                  device=dev)
    _launch(build().at_attention_core, _ptr(qkv), _ptr(ctx), _ptr(p),
            _ptr(None if dtype == _F32 else saved), int(dtype == _BF16), b,
            seq, c, num_heads, float(scale), _stream())
    return ctx, saved, p


def _attention_train(x2, qkv_w, qkv_b, proj_w, proj_b, seq, num_heads, scale,
                     lin, core):
    # the output projection is an f32 product of the f32 context and the
    # upcast weights, rounded once to x's dtype (pallas_kernels.py:294-308)
    dt = x2.dtype
    ctx, qkv, p = core(lin(x2, qkv_w, qkv_b), seq, num_heads, scale, dt)
    return lin(ctx, proj_w.float(), proj_b, out_dtype=dt), qkv, p


def attention_train_fwd_plain(x2, qkv_w, qkv_b, proj_w, proj_b, seq,
                              num_heads, scale):
    return _attention_train(x2, qkv_w, qkv_b, proj_w, proj_b, seq, num_heads,
                            scale, linear_plain, attention_train_core_plain)


def attention_train_fwd(x2: torch.Tensor, qkv_w: torch.Tensor,
                        qkv_b: torch.Tensor, proj_w: torch.Tensor,
                        proj_b: torch.Tensor, seq: int, num_heads: int,
                        scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5 forward on ``x2 [B*seq, C]`` (float32 or bfloat16) with
    ``qkv_w [3C, C]`` and ``proj_w [C, C]`` in x's dtype (``Linear``
    layout), float32 biases: per (sequence, head) ``softmax(q*scale . k^T)``
    from the float32 projection, ``P.v`` with P in float32, then the output
    projection of the float32 context (an f32 product, ``wa_linear``, with
    the weights upcast).  Returns ``(out [B*seq, C], qkv [B*seq, 3C], P [B,
    heads, seq, seq])``, all in x's dtype; qkv and P are what the backward
    reads."""
    _check_attention_train(x2, qkv_w, qkv_b, proj_w, proj_b, seq, num_heads)
    if not _on_cuda(x2, qkv_w, qkv_b, proj_w, proj_b):
        return attention_train_fwd_plain(x2, qkv_w, qkv_b, proj_w, proj_b,
                                         seq, num_heads, scale)
    LAUNCHES["attention_train"] += 1
    return _attention_train(x2, qkv_w, qkv_b, proj_w, proj_b, seq, num_heads,
                            scale, linear, attention_train_core)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 product of the exact upcast operands (float32 sums)."""
    return a.float() @ b.float()


def attention_train_bwd(x2, qkv, p, qkv_w, proj_w, g2, seq, num_heads, scale):
    """K5's backward from the saved ``x2``, ``qkv``, ``P`` and the weights
    (``_attn_train_bwd``, ``pallas_kernels.py:379-430``): matmuls in x's
    dtype (float32 sums), the softmax backward and the q/k products in
    float32.  Returns ``(dx, dqkv_w, dqkv_b, dproj_w, dproj_b)`` with
    dx and the weight gradients in x's dtype, the bias gradients float32."""
    dt = x2.dtype
    rows, c = x2.shape
    b, d = rows // seq, c // num_heads
    q, k, v = qkv.view(b, seq, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    g = g2.to(dt)
    o = (p @ v).transpose(1, 2).reshape(rows, c)            # [rows, C], dt
    d_proj_w = g.t() @ o
    d_proj_b = g.float().sum(0)
    do = (g @ proj_w).view(b, seq, num_heads, d).transpose(1, 2)
    dp = _mm32(do, v.transpose(-1, -2))                     # [b, h, S, S]
    dv = p.transpose(-1, -2) @ do
    pf = p.float()
    ds = (pf * (dp - (dp * pf).sum(-1, keepdim=True))).to(dt)
    dq = (_mm32(ds, k) * scale).to(dt)
    dk = (_mm32(ds.transpose(-1, -2), q) * scale).to(dt)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(rows, 3 * c)
    d_qkv_w = dqkv.t() @ x2
    d_qkv_b = dqkv.float().sum(0)
    dx = dqkv @ qkv_w
    return dx, d_qkv_w, d_qkv_b, d_proj_w, d_proj_b


class AttentionTrainFused(torch.autograd.Function):
    """K5 with its saving backward: the forward (``fwd``: the kernel's
    wrapper or its plain version) keeps qkv and P, the backward reads them
    and recomputes nothing (``_attn_train_core``'s custom VJP)."""

    @staticmethod
    def forward(ctx, x2, qkv_w, qkv_b, proj_w, proj_b, seq, num_heads, scale,
                fwd):
        out, qkv, p = fwd(x2, qkv_w, qkv_b, proj_w, proj_b, seq, num_heads,
                          scale)
        ctx.attn = (seq, num_heads, scale)
        ctx.save_for_backward(x2, qkv, p, qkv_w, proj_w)
        return out

    @staticmethod
    def backward(ctx, g):
        x2, qkv, p, qkv_w, proj_w = ctx.saved_tensors
        grads = attention_train_bwd(x2, qkv, p, qkv_w, proj_w, g, *ctx.attn)
        return (*grads, None, None, None, None)


def _attention_train_fused(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, scale,
                           fwd):
    b, n, c = x.shape
    out = AttentionTrainFused.apply(x.contiguous().view(b * n, c), qkv_w,
                                    qkv_b, proj_w, proj_b, n, num_heads,
                                    float(scale), fwd)
    return out.view(b, n, c)


def attention_train_fused(x: torch.Tensor, qkv_w: torch.Tensor,
                          qkv_b: torch.Tensor, proj_w: torch.Tensor,
                          proj_b: torch.Tensor, num_heads: int,
                          scale: float) -> torch.Tensor:
    """Differentiable K5 (``pallas_kernels.attention_train_fused``): ``x
    [B, N, C]`` -> ``[B, N, C]`` in x's dtype, gradients to x and the four
    projections; weights in ``Linear`` layout (``qkv_w [3C, C]``, ``proj_w
    [C, C]``) in x's dtype, biases float32."""
    if _PLAIN:
        return attention_train_fused_plain(x, qkv_w, qkv_b, proj_w, proj_b,
                                           num_heads, scale)
    return _attention_train_fused(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                                  scale, attention_train_fwd)


def attention_train_fused_plain(x: torch.Tensor, qkv_w: torch.Tensor,
                                qkv_b: torch.Tensor, proj_w: torch.Tensor,
                                proj_b: torch.Tensor, num_heads: int,
                                scale: float) -> torch.Tensor:
    """The plain route of :func:`attention_train_fused`: the forward's
    plain version under the same backward.  The backward is PyTorch on
    both routes (XLA in the JAX package), and under bfloat16 it rounds
    where ``_attn_train_bwd`` rounds; autograd through the plain forward
    would round elsewhere (tests/test_torch_attn_train.py holds both
    against JAX)."""
    return _attention_train_fused(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                                  scale, attention_train_fwd_plain)


# ---------------------------------------------------------------------------
# K6: label -> smoothed 3-class vector
# ---------------------------------------------------------------------------

def label2vec_smooth_plain(label: torch.Tensor,
                           smoothing: float = 0.0) -> torch.Tensor:
    c2 = torch.clamp(torch.where(label >= 1.05, label - 1.0, 0.0), max=1.0)
    c1 = torch.where(label > 0.95, 1.0 - c2, 0.0)
    c0 = torch.where(label <= 0.95, 1.0, 0.0)
    y = torch.stack([c0, c1, c2], dim=-1)
    if smoothing:
        y = y * (1.0 - smoothing) + smoothing / 3.0
    return y


def label2vec_smooth(label: torch.Tensor, smoothing: float = 0.0
                     ) -> torch.Tensor:
    """K6: float32 soft labels ``[...]`` -> ``[..., 3]`` float32
    (``data/labels.label2vec`` with 3 classes), then ``y * (1 - s) + s/3``
    when ``smoothing`` is not 0."""
    _check(label, "label", (_F32,))
    if not _on_cuda(label):
        return label2vec_smooth_plain(label, smoothing)
    n = label.numel()
    if not 0 < n < 2 ** 31 // 3:
        raise ValueError(f"label2vec_smooth takes 1 to {2 ** 31 // 3 - 1} "
                         f"labels, got {n}")
    out = torch.empty((*label.shape, 3), dtype=_F32, device=label.device)
    _launch(build().label2vec_smooth, _ptr(label), _ptr(out), n,
            int(bool(smoothing)), float(1.0 - smoothing),
            float(smoothing / 3.0), _stream())
    return out

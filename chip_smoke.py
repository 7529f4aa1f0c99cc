#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``ultrasound_modeling_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU and the
CUDA toolkit:

    python3 chip_smoke.py [--seed 0]

Phases (each checks its results; any failure exits non-zero):

1. print the card (``nvidia-smi``) and build the kernels from ``csrc/``;
   print ptxas's registers and spills of K2's functions; for each function
   of the kernels built on the tensor cores (the
   attention forward core, K4's per-window forward core, both passes of
   K3's backward, K4's backward kernels (its attention kernel and
   ``wa_wgrad``'s wgmma weight gradients), and the wgmma GEMM
   behind ``tb_linear`` and ``wa_linear`` with wa_linear's narrow
   schedule) print ptxas's registers, spills
   and shared memory and the count of HMMA / HGMMA instructions in its SASS
   (``cuobjdump -sass``), which must not be 0 (the GEMM's bf16 and f32
   builds and the narrow schedule's all);
2. hold every CUDA kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it, with medians of kernel and plain
   times, the kernel's bound (the larger of its bytes over 3.35 TB/s and
   its operations over the peak of their type: 989 TFLOP/s bf16, 165 for
   f32-contract products (3xTF32), 67 for other f32 work) and, where one
   PyTorch call computes the same function, that call's time (SDPA for the
   attention cores and K3, SDPA plus autograd for K3's backward,
   ``F.multi_head_attention_forward`` for K4, ``F.linear`` and
   ``F.layer_norm``; the port never calls them): K1 one layer at the
   TransUNet shape (b64, S 80, C 512) and the ViT shape (b64, S 160, C
   1280, 8 heads), each with and without the folded final LayerNorm; K1's
   and K4's attention cores at both shapes; K4 at the TransUNet and ViT f32
   shapes; at the four Swin stages at b64 (stage 1: 4,096 windows of 20
   tokens, C 96, 3 heads, bias table and shift mask; N 20 at C 96 / 192 /
   384 with the shift mask, N 9 at C 768 with the bias table alone) K4's
   per-window core (``wa_window_fwd``, beside SDPA f32 with the additive
   matrix as attn_mask; at stage 1 two calls bit-equal), its qkv and proj
   products on the schedule ``linear_plan`` picks (``wa_linear_narrow``
   or ``wa_linear``, beside F.linear f32), each also as device time a call
   back to back, the narrow schedule's qkv product of a bf16-origin A with
   its A_lo pass dropped (bit-equal to three passes, both timed), and K4's
   whole forward with an f32 and a bf16 input;
   K4's backward at the four Swin stages at b64: its
   attention kernel ``wa_attention_bwd`` against its plain version beside
   SDPA's backward, its weight and bias gradients ``wa_wgrad`` against
   theirs with x and g f32 and upcast from bf16 (two calls bit-equal, the
   dropped lo pass bit-equal to three passes), both kernels also as device
   time a call back to back past the L2 (``wa_wgrad`` beside the parent's
   torch.matmul steps), and the whole backward (autograd through
   ``WindowAttentionFused``) in f32 and bf16 against autograd through the
   plain version, beside autograd's backward of
   ``F.multi_head_attention_forward``; at stage 1 the kernel's two calls
   bit-equal, the memory the forward keeps for the backward and the
   backward's peak extra memory, beside the plain route's, the time of
   each of its steps and the aten operators it dispatches (no product:
   its weight gradients are ``wa_wgrad``'s); K2 (forward and backward, f32 and bf16,
   LeakyReLU folded, at the eight branch shapes of the flagship's four
   stages at batch 32, each also as device time per launch over inputs
   read in turn past the L2, beside ``F.group_norm`` and autograd's
   backward of it, its library yardsticks); K3 (forward and backward, f32 and bf16) at
   the TransUNet (b32, N 80, C 512) and ViT (b8, N 160, C 1280) train
   shapes; K5's forward (out, saved qkv and P; f32 and bf16) at the ViT
   (b8) and TransUNet (b32) train shapes and its core at b8; K6 on [32,
   256, 80] labels; ``tb_linear`` and ``wa_linear`` at the ViT serving
   shapes (b64: qkv, proj, fc1, fc2) and the K5 ViT train shape (b8),
   beside ``F.linear`` on the same operands, ``wa_linear``'s rows (and the
   TransUNet qkv's) each beside its time recorded when its 128 x 128
   schedule was built (``PERF.md`` section 6), and the host's time to
   enqueue one ``linear`` call (two TMA descriptors encoded per launch);
3. the full-width forward (default config, seeded random weights in the
   flax layout loaded through the bridge) in f32 and bf16, kernel path
   against the all-plain path (``kernels.plain_versions()``, which must
   launch nothing; so in 5, 8b and 8c), with launch counts and frames/s: 3 the
   TransUNet (K2's forward for each eval branch norm on the kernel path),
   3b the ViT, 3c the Swin (K4 in each of its 12 blocks, f32
   and bf16), batch 64; 3d the ResNeStUNet (256x64x6) and 3e the
   MobileUNet (256x64x15), which have no kernel on their path: the card's
   f32 forward at batch 64 against the port's CPU forward of the first 4
   frames (max abs probability difference 1e-4, TF32 off), bf16 against
   f32 on the card (0.05, argmax agreement 0.99), no kernel launched,
   frames/s and peak memory;
4. the serving main paths: ``serve --model {transunet,vit,swin,
   resnest_unet,mobileunet}`` as a user starts it (npz -> bridge -> model
   -> the port's ``InferenceServer``), f32 and bf16, answering concurrent
   ``/predict`` requests; the launch counters are zeroed just before each
   and read just after, and the family's kernels (K1's and K4's; the
   Swin's K4 with its per-window core and wa_linear's narrow schedule;
   none for the two U-Nets) must have launched;
5. one train step at full width and each family's batch (TransUNet 32, ViT
   8, Swin 32), kernel route (K2 in the TransUNet; K3 under flash, K5 under
   pallas; K4 with its backward in the Swin, ``wa_wgrad`` launched in
   every K4 backward) against the plain route from
   the same seeded weights, batch and drop-path generator state,
   augmentation off: loss and every parameter gradient, TransUNet f32
   composed, flash and pallas and bf16 flash, ViT f32 composed, flash and
   pallas and bf16 pallas and flash, Swin f32 and bf16; then ms/step and
   frames/s of the whole step (augmentation on) on both routes, in turns;
   5b the two U-Nets' train step as their Trainer builds it (loss,
   optimizer rule, dropout from the state's generator, augmentation on) at
   full width and the family's batch (ResNeStUNet 64: class_balanced, Adam
   unclipped; MobileUNet 256: pixelcnn, the dual-rate Adam), f32 and bf16:
   a finite loss and finite gradients, the running statistics moved, no
   kernel launched, the MobileUNet's encoder moved 0.1 as far as its
   decoder, ms/step and peak memory; and the loss and every gradient at
   batch 4 with the same dropout masks, card against the port's CPU: the
   f32 loss within 1e-5, and the loss and every gradient leaf in float64
   within phase 5's f32 gates (float32 gradients of these families sit
   2e-3 to 2e-2 of a leaf's max from float64 on one device alone, where a
   ReLU input within rounding of 0 flips; the float32 figure is printed);
6. the train main paths: ``cli train --synthetic --epochs 1`` as a user
   starts it: the TransUNet in f32, f32 ``--attn-train flash`` and ``--bf16
   --attn-train flash`` (batch 32, two steps), the ViT with ``--attn-train
   pallas`` and ``--bf16 --attn-train flash`` (batch 8, eight steps), the
   Swin and the Swin ``--bf16`` (batch 32, two steps), the ResNeStUNet
   (batch 64) and the MobileUNet (batch 256), two steps each; the counters
   are zeroed just before each run and read just after: K2 must have
   launched in every TransUNet run, K3 in the flash runs, K5 in the pallas
   run, K4 (its per-window core and wa_linear's narrow schedule among its
   kernels) and its backward kernels in the Swin runs, none in the U-Net
   runs; the loss is finite and the weights (and the BatchNorm running
   statistics) moved;
7. K6, which no path of the system calls, as a caller uses it: the
   smoothed targets of a batch's labels, against ``label2vec`` plus the
   smoothing.

The line before the last is a JSON summary of the kernels (launches summed
over the main paths above; times, bound and library time at each kernel's
first, main-path shape), after the card's name and power limit; the last
line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or outside a checkout, it exits non-zero
and prints no result.  JAX is never imported.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "ultrasound_modeling_tpu_torch"

# the JAX package's Pallas kernels these ports replace
K1_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:781"
K4_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:152"
K1_SRC = f"{PKG}/csrc/transformer_block.cu"
K4_SRC = f"{PKG}/csrc/window_attention.cu"
K4B_SRC = f"{PKG}/csrc/window_attention_bwd.cu"
K4W_SRC = f"{PKG}/csrc/window_attention_wgrad.cu"
GEMM_SRC = f"{PKG}/csrc/gemm_sm90.cuh"
K4B_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:206"
K2_SRC = f"{PKG}/csrc/group_flat_norm.cu"
K3_SRC = f"{PKG}/csrc/flash_attention.cu"
K2_FWD_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:1037"
K2_BWD_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:1066"
K3_FWD_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:583"
K3_BWD_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:614"
K5_SRC = f"{PKG}/csrc/attention_train.cu"
K6_SRC = f"{PKG}/csrc/label2vec.cu"
K5_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:311"
K6_TPU = "ultrasound_modeling_tpu/ops/pallas_kernels.py:1157"
BATCH = 64  # the serving batch (cli serve --max-batch default)
# TrainConfig.batch_size of each family
TRAIN_BATCH = {"transunet": 32, "vit": 8, "swin": 32, "resnest_unet": 64,
               "mobileunet": 256}
# the two families with no kernel on their path, each with its phases
UNETS = (("resnest_unet", "d"), ("mobileunet", "e"))
# the kernels each main path must launch
K4_KERNELS = ("window_attention", "wa_linear", "wa_attention_core")
# K4's kernels at the Swin's shapes: the per-window core (windows of at most
# 32 tokens) and wa_linear's narrow schedule (K a whole multiple of 96)
K4_SWIN_KERNELS = K4_KERNELS + ("wa_window_fwd", "wa_linear_narrow")
K4_TRAIN_KERNELS = K4_SWIN_KERNELS + ("wa_attention_bwd", "wa_wgrad")
SERVE_KERNELS = {fam: ("transformer_block", "tb_layer_norm", "tb_linear",
                       "tb_attention_core") + K4_KERNELS
                 for fam in ("transunet", "vit")}
SERVE_KERNELS["swin"] = K4_SWIN_KERNELS
# the TransUNet's eval branch norms: K2's forward op and its kernel
EVAL_NORM_KERNELS = ("group_flat_norm", "group_flat_norm_fwd")
SERVE_KERNELS["transunet"] += EVAL_NORM_KERNELS
SERVE_KERNELS.update({fam: () for fam, _ in UNETS})
K2_KERNELS = ("group_flat_norm_fwd", "group_flat_norm_bwd")
K3_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
K5_KERNELS = ("attention_train", "at_attention_core")
K6_KERNELS = ("label2vec_smooth",)
K1_KERNELS = ("transformer_block", "tb_layer_norm", "tb_linear",
              "tb_attention_core")
# the phase-6 run that saves a checkpoint, which phase 8 serves
CKPT_RUN = "transunet/f32/xla"


START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's first line also gets the seconds since the
    script started."""
    if msg.startswith("phase "):
        msg = f"{msg}  [{time.perf_counter() - START:.1f} s]"
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def require(ok, msg) -> None:
    if not ok:
        raise SmokeFailure(msg)


# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, at a
# 700 W limit): HBM bytes/s; bf16 tensor-core FLOP/s; products held to the
# f32 contract, whose fastest f32-accurate route is 3xTF32 on the tensor
# cores (495 TFLOP/s TF32 / 3); other f32 arithmetic on the SIMT units.
HBM_BYTES_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32_MM = 495e12 / 3
PEAK_F32 = 67e12


def mm(m, n, k, peak):
    """(operations, peak) of an [m, k] x [k, n] product."""
    return (2.0 * m * n * k, peak)


def attn(b, h, s, d, pv_peak=PEAK_F32_MM, qk_peak=PEAK_F32_MM, products=2):
    """(operations, peak) of per-(sequence, head) attention products: the
    scores, then P.V (and, for a backward, three more at pv_peak)."""
    one = 2.0 * b * h * s * s * d
    return [(one, qk_peak), ((products - 1) * one, pv_peak)]


def elementwise(n, per=10):
    """(operations, peak) of ~per f32 operations on each of n values."""
    return (float(n) * per, PEAK_F32)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Checks:
    """Kernel-vs-plain results; ``results[name]`` keeps the first (main
    path shape) measurement of each kernel for the JSON summary."""

    def __init__(self):
        self.results = {}

    def compare(self, name, label, kernel_fn, plain_fn, tol_fn, tol_text,
                inputs=(), ops=(), library=None, library_text="none"):
        """``kernel_fn`` / ``plain_fn`` return a tensor or a tuple of them;
        ``tol_fn`` is one function of the plain output or a tuple of them,
        one per output.  The error reported is the largest over outputs.

        The bound is the larger of the bytes moved (each tensor of
        ``inputs`` read once, each output written once) over the HBM rate
        and the sum of ``ops`` ((operations, peak) pairs) over their peaks.
        ``library``: one PyTorch call computing the same function on the
        same inputs (the yardstick; the port never calls it), or None with
        ``library_text`` saying why there is none.  Returns this call's
        measurements."""
        import torch
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        if isinstance(got, torch.Tensor):
            got, want, tol_fn = (got,), (want,), (tol_fn,)
        seen, moved = set(), 0
        for t in (*inputs, *got):
            if t is not None and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                moved += t.numel() * t.element_size()
        ops = [ops] if ops and not isinstance(ops[0], (tuple, list)) else ops
        bytes_ms = 1e3 * moved / HBM_BYTES_S
        ops_ms = 1e3 * sum(n / peak for n, peak in ops)
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        errs = [(g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want)]
        tols = [f(w) for f, w in zip(tol_fn, want)]
        ok = (all(bool(torch.isfinite(g.float()).all()) for g in got)
              and all(e <= t for e, t in zip(errs, tols)))
        err, tol = max(errs), max(tols)
        ms = time_ms(kernel_fn)
        plain_ms = time_ms(plain_fn)
        library_ms = time_ms(library) if library is not None else None
        lib = (f"{library_ms:.4f} ms ({library_text})" if library is not None
               else f"none ({library_text})")
        log(f"  {name:18s} {label:34s} max_abs_err "
            f"{' '.join(f'{e:.3e}' for e in errs)} <= "
            f"{' '.join(f'{t:.3e}' for t in tols)} "
            f"({tol_text}) {'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
            f"library {lib}")
        require(ok, f"{name} {label}: max_abs_err {errs} > {tols}")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
        self.results.setdefault(name, row)
        return row


# wa_linear's single-call times at the TransUNet, ViT and K5 shapes recorded
# when its 128 x 128 schedule was built (PERF.md section 6, NVIDIA H100 80GB
# HBM3, 700.00 W); those shapes keep that schedule, and their rows print
# these beside their own
RECORDED_WA_LINEAR_MS = {(5120, 1536, 512): 0.139, (10240, 3840, 1280): 1.223,
                    (10240, 1280, 1280): 0.461, (1280, 3840, 1280): 0.214,
                    (1280, 1280, 1280): 0.083}


def log_beside_recorded(row, m, n, k, call) -> None:
    """The wa_linear row's single-call time (the host's enqueue included)
    beside the recorded one at its shape, and ``call``'s device time back
    to back."""
    log(f"    wa_linear {m}x{n}x{k}: {row['ms']:.4f} ms here, "
        f"{RECORDED_WA_LINEAR_MS[(m, n, k)]:.3f} ms recorded, single calls; "
        f"device {back_to_back_ms([call]):.4f} ms a call back to back")


def bf16_quanta(n):
    """n bf16 quanta (2^-8 relative) of max|want|."""
    return lambda want: n * want.float().abs().max().item() / 256.0


def f32_tol(want):
    """f32 sums in another order: 1e-4 relative to max(1, max|want|)."""
    return 1e-4 * max(1.0, want.abs().max().item())


# the kernel functions built on the tensor cores: the attention kernels (K4's
# per-window forward core and its backward among them), the GEMM of
# tb_linear (bf16) and wa_linear (f32), and wa_linear's narrow schedule
TENSOR_CORE_KERNELS = ("attention_fwd_kernel", "fa_bwd_query_kernel",
                       "fa_bwd_key_kernel", "wa_bwd_kernel", "wa_wgrad_kernel",
                       "wa_window_fwd_kernel", "linear_wgmma_kernel",
                       "linear_narrow_kernel")
# each operand type the GEMM is built for must hold wgmma (HGMMA); the
# names demangled or not
GEMM_BUILDS = {"bf16": r"linear_wgmma_kernel(<|I13)__nv_bfloat16",
               "f32": r"linear_wgmma_kernel(<float|If)",
               "f32 narrow": r"linear_narrow_kernel"}


def kernel_report(K, kernels=TENSOR_CORE_KERNELS):
    """Per kernel function whose name holds one of ``kernels``: registers,
    stack and static shared memory (``cuobjdump -res-usage``), bytes
    spilled (ptxas -v in the build log, when this process built the
    libraries) and the tensor-core MMA instructions in its SASS
    (``cuobjdump -sass``)."""
    bindir = os.path.dirname(K._nvcc())

    def tool(name):
        path = os.path.join(bindir, name)
        return path if os.path.exists(path) else name

    def short(name):
        for exe in (tool("cu++filt"), "c++filt"):
            try:
                out = subprocess.run([exe, name], capture_output=True, text=True,
                                     timeout=30).stdout.strip()
            except OSError:
                continue
            if out and out != name:
                return re.sub(r"\(.*", "", out).replace("(anonymous namespace)::", "")
        return name

    spills, fn = {}, None
    for ln in K.BUILD_LOG.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
        elif fn and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            spills[fn] = int(m.group(1)) + int(m.group(2))
    usage, mma = {}, {}
    for lib in sorted(K.BUILD_DIR.glob("lib*.so")):
        res = subprocess.run([tool("cuobjdump"), "-res-usage", str(lib)],
                             capture_output=True, text=True, timeout=300).stdout
        fn = None
        for ln in res.splitlines():
            m = re.search(r"Function (\S+?):?\s*$", ln)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", ln)
            if fn and m:
                usage[fn] = tuple(int(x) for x in m.groups())
        sass = subprocess.run([tool("cuobjdump"), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300).stdout
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                fn = m.group(1)
                mma.setdefault(fn, 0)
            elif fn and re.search(r"\bH(G)?MMA\b", ln):
                mma[fn] += 1
    rows = []
    for fn in sorted(set(usage) | set(mma)):
        if any(k in fn for k in kernels):
            reg, stack, shared, _ = usage.get(fn, (None,) * 4)
            spill = (f"spilled {spills[fn]} bytes" if fn in spills else
                     f"stack frame {stack} bytes (its spills are in the log of "
                     f"the build that made the library)")
            rows.append((short(fn), reg, spill, shared, mma.get(fn, 0)))
    return rows


def phase_tensor_cores(K) -> None:
    """Phase 1's report of the tensor-core kernels; each must hold
    tensor-core MMAs, and each build of the GEMM wgmma."""
    import torch
    rows = kernel_report(K)
    log("  tensor-core kernels (ptxas -v; MMA instructions in the SASS):")
    for name, regs, spill, smem, mma_n in rows:
        log(f"    {name}: {regs} registers, {spill}, {smem} bytes static smem, "
            f"{mma_n} HMMA/HGMMA")
    for kern in TENSOR_CORE_KERNELS:
        found = [r for r in rows if kern in r[0]]
        require(found and all(r[4] > 0 for r in found),
                f"{kern}: no tensor-core MMA in its SASS: {found}")
    for build, pattern in GEMM_BUILDS.items():
        found = [r for r in rows if re.search(pattern, r[0])]
        require(found and all(r[4] > 0 for r in found),
                f"{build} GEMM: no build, or no HGMMA in its SASS: {found}")


def phase_train_kernels(checks: Checks, dev, seed: int) -> None:
    """K2 and K3, forward and backward, against their plain versions."""
    import torch
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cpu").manual_seed(seed + 7)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    log("phase 2 (train kernels): K2 and K3 vs plain PyTorch on the card")
    eps, alpha = 1e-3, 0.3
    # The biases are +-(|scale| sqrt(gsize-1) + 1) by channel: no
    # pre-activation lies near the LeakyReLU's kink, where a rounding
    # difference could send the kernel and the plain version down the two
    # (equally right) branches of the derivative.
    why = ("no one call normalizes each channel group of a row with a "
           "per-channel affine and the folded LeakyReLU")
    for rows, f, gsize in GFN_SHAPES:
        for dt, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            y = rand(rows, f, scale=2.0, dtype=dt) + 0.5
            s = 1 + rand(f, scale=0.1)
            sign = torch.where(torch.arange(f, device=dev) % 2 == 0, 1.0, -1.0)
            b = sign * (s.abs() * (gsize - 1) ** 0.5 + 1)
            go = rand(rows, f, dtype=dt)
            label = f"{rows}x{f} g{gsize} leaky {dname}"
            tol, text = ((f32_tol, "1e-4 x max(1,|plain|)") if dname == "f32"
                         else (bf16_quanta(2), "2 bf16 quanta"))
            args = (y, s, b, gsize, eps, alpha)
            lib_fwd, lib_bwd = group_norm_calls(y, go, s, b, f // gsize, eps)
            fwd = checks.compare("group_flat_norm_fwd", label,
                                 lambda: K.group_flat_norm_fwd(*args),
                                 lambda: K.group_flat_norm_fwd_plain(*args),
                                 tol, text, inputs=(y, s, b),
                                 ops=elementwise(rows * f, 10), library=lib_fwd,
                                 library_text=f"F.group_norm {dname} alone, "
                                              f"no LeakyReLU; {why}")
            bargs = (y, go, s, b, gsize, eps, alpha)
            bwd = checks.compare("group_flat_norm_bwd", label,
                                 lambda: K.group_flat_norm_bwd(*bargs),
                                 lambda: K.group_flat_norm_bwd_plain(*bargs),
                                 (tol, f32_tol, f32_tol),
                                 f"dy {text}; dscale, dbias (float32 sums over "
                                 f"all rows) 1e-4 x max(1,|plain|)",
                                 inputs=(y, go, s, b), ops=elementwise(rows * f, 20),
                                 library=lib_bwd,
                                 library_text=f"autograd.grad of F.group_norm "
                                              f"{dname} alone; {why}")
            again = K.group_flat_norm_bwd(*bargs)
            first = K.group_flat_norm_bwd(*bargs)
            require(torch.equal(again[1], first[1])
                    and torch.equal(again[2], first[2]),
                    f"K2 dscale/dbias differ between runs at {label}")
            del again, first
            per = k2_per_launch(K, y, go, s, b, gsize, eps, alpha)
            log(f"  K2 {label}: device time per launch ({per['sets']} input "
                f"sets, {per['mb']:.0f} MB read in turn): fwd kernel "
                f"{per['fwd']:.4f} ms, F.group_norm {per['lib_fwd']:.4f} ms, "
                f"bound {fwd['bound_ms']:.4f} ms ({fwd['bound_ms'] / per['fwd']:.0%}"
                f" of it); bwd kernel {per['bwd']:.4f} ms, autograd.grad of "
                f"F.group_norm {per['lib_bwd']:.4f} ms, bound {bwd['bound_ms']:.4f} "
                f"ms ({bwd['bound_ms'] / per['bwd']:.0%} of it); a copy of y "
                f"{per['copy']:.4f} ms")
            del y, go, lib_fwd, lib_bwd
    torch.cuda.empty_cache()
    # K3 at the TransUNet (b32, N 80, C 512, 4 heads) and the ViT (b8, N
    # 160, C 1280, 8 heads) train shapes
    for b_, n, c, heads in ((TRAIN_BATCH["transunet"], 80, 512, 4),
                            (TRAIN_BATCH["vit"], 160, 1280, 8)):
        scale, d = heads ** -0.5, c // heads
        qk = rand(b_ * n, 2 * c, scale=0.3)
        for dt, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            qkv = torch.cat([qk, rand(b_ * n, c)], dim=1).to(dt)
            go = rand(b_ * n, c, dtype=dt)
            label = f"b{b_} N{n} C{c} h{heads} {dname}"
            f32 = dname == "f32"
            peak = PEAK_F32_MM if f32 else PEAK_BF16
            tol, text = ((f32_tol, "1e-4 x max(1,|plain|)") if f32
                         else (bf16_quanta(2), "2 bf16 quanta"))
            fwd = checks.compare("flash_attention_fwd", label,
                                 lambda: K.flash_attention_fwd(qkv, n, heads, scale),
                                 lambda: K.flash_attention_fwd_plain(qkv, n, heads, scale),
                                 (tol, f32_tol), f"ctx {text}; LSE 1e-4", inputs=(qkv,),
                                 ops=attn(b_, heads, n, d, peak, peak),
                                 library=lambda: sdpa(qkv, n, heads, scale),
                                 library_text=f"SDPA {dname}, context only")
            _, lse = K.flash_attention_fwd_plain(qkv, n, heads, scale)
            btol, btext = ((f32_tol, "1e-4 x max(1,|plain|)") if f32
                           else (bf16_quanta(4), "4 bf16 quanta"))
            bwd = checks.compare("flash_attention_bwd", label,
                                 lambda: K.flash_attention_bwd(qkv, lse, go, n, heads, scale),
                                 lambda: K.flash_attention_bwd_plain(qkv, lse, go, n,
                                                                     heads, scale),
                                 btol, btext, inputs=(qkv, lse, go),
                                 ops=attn(b_, heads, n, d, peak, peak, products=5),
                                 library=sdpa_bwd(qkv, go, n, heads, scale),
                                 library_text=f"SDPA {dname}: autograd.grad alone")
            both = time_ms(lambda: sdpa_grad(qkv, go, n, heads, scale))
            log(f"  K3 forward + backward {label}: kernel "
                f"{fwd['ms'] + bwd['ms']:.4f} ms, SDPA forward + autograd.grad "
                f"{both:.4f} ms")


# K2 at batch 32, stage-1 branch2 first (the JSON row's shape): (rows, F,
# gsize) of branch2 and branch1 at each of the flagship's four stages
GFN_SHAPES = ((163840, 90, 10), (163840, 27, 3), (40960, 189, 21), (40960, 63, 7),
              (10240, 378, 42), (10240, 126, 14), (2560, 765, 85), (2560, 252, 28))


def k2_report(K) -> None:
    """Registers and bytes spilled of K2's kernel functions."""
    rows = kernel_report(K, ("gfn_",))
    require(rows, "no K2 (gfn_*) kernel function in the libraries")
    for name, regs, spill, _, _ in rows:
        log(f"  K2 {name}: {regs} registers, {spill}")


def group_norm_calls(y, go, s, b, groups, eps):
    """K2's library yardsticks: F.group_norm on the same [rows, F] tensor
    (rows as the batch, F channels in groups of gsize), weights in y's
    dtype, and autograd's backward of it alone (the graph is built once,
    here, and kept).  Timed only; the port never calls them."""
    import torch
    import torch.nn.functional as F
    w, bb = s.to(y.dtype), b.to(y.dtype)
    x = y.detach().requires_grad_()
    wl, bl = w.detach().requires_grad_(), bb.detach().requires_grad_()
    out = F.group_norm(x, groups, wl, bl, eps)
    return (lambda: F.group_norm(y, groups, w, bb, eps),
            lambda: torch.autograd.grad(out, (x, wl, bl), go, retain_graph=True))


def back_to_back_ms(calls, reps: int = 40) -> float:
    """Device time per call of ``reps`` calls run back to back, rotating over
    ``calls``: queued behind a sleep on the card, so the host's enqueue
    stays off the clock, and kept alive to the end, so every output is new
    memory."""
    import torch
    for fn in calls:             # warm, and fill the allocator's cache
        fn()
    keep = [calls[i % len(calls)]() for i in range(reps)]
    del keep
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    a.record()
    keep = [calls[i % len(calls)]() for i in range(reps)]
    b.record()
    queued = not a.query()
    b.synchronize()
    require(queued, "the host had not queued every call before the card "
                    "started them: lengthen the sleep")
    return a.elapsed_time(b) / reps


def k2_per_launch(K, y, go, s, b, gsize, eps, alpha):
    """K2's device time per launch, forward and backward, its library
    yardsticks' and that of a device copy of y (the forward's bytes, the
    rate the card reaches in practice), over copies of the inputs read in
    turn, more than 100 MB in all (past the 50 MB L2, as the train step
    finds them)."""
    import math
    set_bytes = y.numel() * y.element_size()
    sets = max(2, math.ceil(100e6 / set_bytes))
    ys = [y.clone() for _ in range(sets)]
    gs = [go.clone() for _ in range(sets)]
    groups = y.shape[1] // gsize
    libs = [group_norm_calls(yi, gi, s, b, groups, eps) for yi, gi in zip(ys, gs)]
    out = {"sets": sets, "mb": sets * set_bytes / 1e6}
    out["fwd"] = back_to_back_ms(
        [lambda yi=yi: K.group_flat_norm_fwd(yi, s, b, gsize, eps, alpha) for yi in ys])
    out["lib_fwd"] = back_to_back_ms([lib[0] for lib in libs])
    out["bwd"] = back_to_back_ms(
        [lambda yi=yi, gi=gi: K.group_flat_norm_bwd(yi, gi, s, b, gsize, eps, alpha)
         for yi, gi in zip(ys, gs)])
    out["lib_bwd"] = back_to_back_ms([lib[1] for lib in libs])
    out["copy"] = back_to_back_ms([lambda yi=yi: yi.clone() for yi in ys])
    return out


def sdpa(qkv, n, heads, scale, mask=None):
    """The library yardstick of an attention core: one
    scaled_dot_product_attention call on q, k, v views of the packed
    projection, ``mask`` its additive attn_mask (timed only; the port never
    calls it)."""
    import torch.nn.functional as F
    b, c3 = qkv.shape[0] // n, qkv.shape[1]
    q, k, v = qkv.view(b, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def _sdpa_graph(qkv, go, n, heads, scale, mask=None):
    import torch
    x = qkv.detach().requires_grad_()
    out = sdpa(x, n, heads, scale, mask)
    b, h, _, d = out.shape
    return x, out, go.view(b, n, h, d).transpose(1, 2)


def sdpa_grad(qkv, go, n, heads, scale):
    """SDPA forward and autograd's backward to the packed projection."""
    import torch
    x, out, gout = _sdpa_graph(qkv, go, n, heads, scale)
    return torch.autograd.grad(out, x, gout)[0]


def sdpa_bwd(qkv, go, n, heads, scale, mask=None):
    """SDPA's backward alone: the forward runs once, here; each call of the
    function returned runs autograd's backward to the packed projection
    (the graph is kept between calls)."""
    import torch
    x, out, gout = _sdpa_graph(qkv, go, n, heads, scale, mask)
    return lambda: torch.autograd.grad(out, x, gout, retain_graph=True)[0]


def mha(x, qkv_w, qkv_b, proj_w, proj_b, heads, scale, addmask=None):
    """K4's library yardstick: one F.multi_head_attention_forward call on
    the same windows.  Its score scale is fixed at d^-0.5, so the q rows of
    the projection are pre-scaled by scale * d^0.5 (once, here); addmask
    [nW, H, N, N] becomes its per-(window, head) attn_mask."""
    import torch.nn.functional as F
    nbw, n, c = x.shape
    f = scale * (c // heads) ** 0.5
    w, bq = qkv_w.clone(), qkv_b.clone()
    w[:c] *= f
    bq[:c] *= f
    mask = None
    if addmask is not None:
        nw = addmask.shape[0]
        mask = addmask.repeat(nbw // nw, 1, 1, 1).reshape(nbw * heads, n, n)
    xt = x.transpose(0, 1)
    return lambda: F.multi_head_attention_forward(
        xt, xt, xt, c, heads, w, bq, None, None, False, 0.0, proj_w, proj_b,
        training=False, need_weights=False, attn_mask=mask)[0]


def block_ops(b, s, c, heads, mlp):
    """K1's products: four bf16 GEMMs and the attention core."""
    m = b * s
    return [mm(m, 3 * c, c, PEAK_BF16), mm(m, c, c, PEAK_BF16),
            mm(m, mlp, c, PEAK_BF16), mm(m, c, mlp, PEAK_BF16),
            *attn(b, heads, s, c // heads, PEAK_BF16)]


def window_ops(b, s, c, heads):
    """K4's products, all held to the f32 contract."""
    return [mm(b * s, 3 * c, c, PEAK_F32_MM), mm(b * s, c, c, PEAK_F32_MM),
            *attn(b, heads, s, c // heads)]


K1_NONE = ("no one call runs the whole pre-LN block in K1's bf16 / f32 "
           "contract")


def phase_kernels(checks: Checks, dev, seed: int) -> None:
    import torch
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cpu").manual_seed(seed)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    bf = torch.bfloat16
    # K1 at the flagship shape: batch 64 x 80 tokens, C 512, 4 heads, MLP 2048
    b, s, c, heads, mlp = 64, 80, 512, 4, 2048
    eps, scale = 1e-6, 0.5
    lin = c ** -0.5
    w = K.BlockWeights(
        1 + rand(c, scale=0.1), rand(c, scale=0.1),
        torch.cat([rand(c, c, scale=lin * 0.05), rand(c, c, scale=lin * 0.05),
                   rand(c, c, scale=lin)]).to(bf),
        rand(3 * c, scale=0.1), rand(c, c, scale=lin, dtype=bf),
        rand(c, scale=0.1), 1 + rand(c, scale=0.1), rand(c, scale=0.1),
        rand(mlp, c, scale=lin, dtype=bf), rand(mlp, scale=0.1),
        rand(c, mlp, scale=mlp ** -0.5, dtype=bf), rand(c, scale=0.1))
    x = rand(b, s, c, dtype=bf)
    fin = (1 + rand(c, scale=0.1), rand(c, scale=0.1))
    log("phase 2: kernels vs plain PyTorch on the card")
    checks.compare("transformer_block", "K1 b64 S80 C512 h4 mlp2048 bf16",
                   lambda: K.transformer_block(x, w, heads, scale, eps),
                   lambda: K.transformer_block_plain(x, w, heads, scale, eps),
                   bf16_quanta(4), "4 bf16 quanta of max|plain|",
                   inputs=(x, *w), ops=block_ops(b, s, c, heads, mlp),
                   library_text=K1_NONE)
    checks.compare("transformer_block", "K1 same, folded final LN",
                   lambda: K.transformer_block(x, w, heads, scale, eps, fin),
                   lambda: K.transformer_block_plain(x, w, heads, scale, eps, fin),
                   bf16_quanta(4), "4 bf16 quanta of max|plain|",
                   inputs=(x, *w, *fin), ops=block_ops(b, s, c, heads, mlp),
                   library_text=K1_NONE)
    # K1's entry points at the layer's shapes
    x2 = x.reshape(b * s, c)
    h = K.layer_norm_plain(x2, w.ln1_w, w.ln1_b, eps, bf)
    qkv = K.linear_plain(h, w.qkv_w, w.qkv_b)
    h2 = K.layer_norm_plain(qkv[:, :c].contiguous(), w.ln2_w, w.ln2_b, eps, bf)
    m = K.linear_plain(h2, w.fc1_w, w.fc1_b, gelu=True, out_dtype=bf)
    x1 = qkv[:, c:2 * c].contiguous()
    import torch.nn.functional as F
    ln_w, ln_b = w.ln1_w.to(bf), w.ln1_b.to(bf)
    checks.compare("tb_layer_norm", "LN [5120,512] bf16->bf16",
                   lambda: K.layer_norm(x2, w.ln1_w, w.ln1_b, eps, bf),
                   lambda: K.layer_norm_plain(x2, w.ln1_w, w.ln1_b, eps, bf),
                   bf16_quanta(2), "2 bf16 quanta", inputs=(x2, w.ln1_w, w.ln1_b),
                   ops=elementwise(b * s * c, 8),
                   library=lambda: F.layer_norm(x2, (c,), ln_w, ln_b, eps),
                   library_text="F.layer_norm, its weights in bf16")
    checks.compare("tb_layer_norm", "LN [5120,512] f32->bf16",
                   lambda: K.layer_norm(x1, fin[0], fin[1], eps, bf),
                   lambda: K.layer_norm_plain(x1, fin[0], fin[1], eps, bf),
                   bf16_quanta(2), "2 bf16 quanta", inputs=(x1, *fin),
                   ops=elementwise(b * s * c, 8),
                   library_text="no one call takes f32 in and gives bf16 out")
    qkv_bb = w.qkv_b.to(bf)
    checks.compare("tb_linear", "qkv 5120x1536x512 +b ->f32",
                   lambda: K.linear(h, w.qkv_w, w.qkv_b),
                   lambda: K.linear_plain(h, w.qkv_w, w.qkv_b), f32_tol,
                   "1e-4 x max(1,|plain|)", inputs=(h, w.qkv_w, w.qkv_b),
                   ops=mm(b * s, 3 * c, c, PEAK_BF16),
                   library=lambda: F.linear(h, w.qkv_w, qkv_bb),
                   library_text="F.linear bf16 (cuBLAS; bf16 out)")
    checks.compare("tb_linear", "fc1 5120x2048x512 +b GELU ->bf16",
                   lambda: K.linear(h2, w.fc1_w, w.fc1_b, gelu=True, out_dtype=bf),
                   lambda: K.linear_plain(h2, w.fc1_w, w.fc1_b, gelu=True, out_dtype=bf),
                   bf16_quanta(2), "2 bf16 quanta", inputs=(h2, w.fc1_w, w.fc1_b),
                   ops=mm(b * s, mlp, c, PEAK_BF16),
                   library_text="F.linear has no fused GELU")
    checks.compare("tb_linear", "fc2 5120x512x2048 +b +res ->bf16",
                   lambda: K.linear(m, w.fc2_w, w.fc2_b, residual=x1, out_dtype=bf),
                   lambda: K.linear_plain(m, w.fc2_w, w.fc2_b, residual=x1, out_dtype=bf),
                   bf16_quanta(2), "2 bf16 quanta", inputs=(m, w.fc2_w, w.fc2_b, x1),
                   ops=mm(b * s, c, mlp, PEAK_BF16),
                   library_text="F.linear has no fused residual")
    checks.compare("tb_attention_core", "b64 S80 h4 d128 P,V bf16",
                   lambda: K.attention_core(qkv, s, heads, scale, pv_bf16=True, out_dtype=bf),
                   lambda: K.attention_core_plain(qkv, s, heads, scale, pv_bf16=True, out_dtype=bf),
                   bf16_quanta(2), "2 bf16 quanta", inputs=(qkv,),
                   ops=attn(b, heads, s, c // heads, PEAK_BF16),
                   library=lambda: sdpa(qkv, s, heads, scale),
                   library_text="SDPA f32 on the same q, k, v")

    # K4 at the TransUNet f32 shape: batch 64 windows of 80 tokens, no bias
    xf = rand(b, s, c)
    qkv_w = torch.cat([rand(c, c, scale=lin * 0.05), rand(c, c, scale=lin * 0.05),
                       rand(c, c, scale=lin)])
    qkv_b, proj_w, proj_b = rand(3 * c, scale=0.1), rand(c, c, scale=lin), rand(c, scale=0.1)
    args = (xf, qkv_w, qkv_b, proj_w, proj_b, heads)
    mha_text = "F.multi_head_attention_forward, q weights pre-scaled"
    checks.compare("window_attention", "K4 b64 N80 C512 h4 f32 no bias",
                   lambda: K.window_attention(*args, scale=scale),
                   lambda: K.window_attention_plain(*args, scale=scale),
                   f32_tol, "1e-4 x max(1,|plain|)", inputs=args[:5],
                   ops=window_ops(b, s, c, heads),
                   library=mha(*args, scale), library_text=mha_text)
    xq = K.linear_plain(xf.reshape(b * s, c), qkv_w, qkv_b)
    row = checks.compare("wa_linear", "qkv 5120x1536x512 f32",
                         lambda: K.linear(xf.reshape(b * s, c), qkv_w, qkv_b),
                         lambda: K.linear_plain(xf.reshape(b * s, c), qkv_w, qkv_b),
                         f32_tol, "1e-4 x max(1,|plain|)", inputs=(xf, qkv_w, qkv_b),
                         ops=mm(b * s, 3 * c, c, PEAK_F32_MM),
                         library=lambda: F.linear(xf.reshape(b * s, c), qkv_w, qkv_b),
                         library_text="F.linear f32 (cuBLAS, TF32 off)")
    log_beside_recorded(row, b * s, 3 * c, c,
                   lambda: K.linear(xf.reshape(b * s, c), qkv_w, qkv_b))
    checks.compare("wa_attention_core", "b64 S80 h4 d128 f32",
                   lambda: K.attention_core(xq, s, heads, scale),
                   lambda: K.attention_core_plain(xq, s, heads, scale),
                   f32_tol, "1e-4 x max(1,|plain|)", inputs=(xq,),
                   ops=attn(b, heads, s, c // heads),
                   library=lambda: sdpa(xq, s, heads, scale),
                   library_text="SDPA f32 on the same q, k, v")
    ops = torch.ops.ultrasound_port
    k1 = (x, list(w), heads, float(scale), float(eps), None, None)
    k4 = (*args, None, float(scale))
    log("  dispatch, host us a call (enqueue only, least of 7 rounds of 20): "
        f"K1 through its op {host_us(lambda: ops.transformer_block.default(*k1)):.1f}, "
        f"its CUDA implementation called directly "
        f"{host_us(lambda: K._transformer_block_cuda(*k1)):.1f}; K4 "
        f"{host_us(lambda: ops.window_attention.default(*k4)):.1f} / "
        f"{host_us(lambda: K._window_attention_cuda(*k4)):.1f}")
    phase_swin_k4(checks, dev, rand)


def host_us(fn, calls: int = 20, rounds: int = 7) -> float:
    """The least host time of one call of ``fn``, its enqueue alone: the
    queue is drained before each round of ``calls`` calls and not inside
    it."""
    import torch
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return best * 1e6


def k4_grads(fn, args, heads, kw, go):
    """K4's backward alone, through autograd of ``fn`` (the differentiable
    K4 or its plain version): the forward runs once, here; each call of
    the function returned runs the backward to x, both projections, both
    biases and the bias table (the graph is kept between calls)."""
    import torch
    leaves = [a.detach().requires_grad_() for a in args]
    out = fn(*leaves[:5], heads, bias_table=leaves[5], **kw)
    return lambda: torch.autograd.grad(out, leaves, go, retain_graph=True)


def mha_bwd(args, heads, scale, addmask, go):
    """The library yardstick of K4's backward: autograd's backward alone of
    one F.multi_head_attention_forward call (``mha``) to x, both
    projections and both biases (timed only)."""
    import torch
    leaves = [a.detach().requires_grad_() for a in args[:5]]
    out = mha(*leaves, heads, scale, addmask)()
    got = go.transpose(0, 1)
    return lambda: torch.autograd.grad(out, leaves, got, retain_graph=True)


def window_bwd_ops(b, s, c, heads):
    """K4 backward's products, all held to the f32 contract: the recompute
    (qkv, scores, P.V), then d_proj_w, do, dP, dV, dQ, dK, d_qkv_w, dx."""
    return [mm(b * s, 3 * c, c, PEAK_F32_MM), mm(b * s, c, c, PEAK_F32_MM),
            mm(b * s, c, c, PEAK_F32_MM), mm(b * s, 3 * c, c, PEAK_F32_MM),
            mm(b * s, 3 * c, c, PEAK_F32_MM),
            *attn(b, heads, s, c // heads, products=6)]


# the Swin's four stages at full width: (token grid, window, C, heads,
# shifted); K4 runs there at N 20, 20, 20 and 9 (stage 4's 8x3 grid padded
# to 9x3)
SWIN_STAGES = (((64, 20), (4, 5), 96, 3, True), ((32, 10), (4, 5), 192, 6, True),
               ((16, 5), (4, 5), 384, 12, True), ((9, 3), (3, 3), 768, 24, False))


def swin_stage_inputs(dev, rand, stage):
    """K4's inputs at a Swin stage, batch 64: x f32 [nBW, N, C], (qkv_w,
    qkv_b, proj_w, proj_b), the bias table, the kwargs (rel_index, shift
    mask or None) and the additive matrix [nW, heads, N, N]."""
    import torch
    from ultrasound_modeling_tpu_torch.ops import window_attn

    grid, window, c, heads, shifted = SWIN_STAGES[stage]
    n = window[0] * window[1]
    nbw = BATCH * (grid[0] // window[0]) * (grid[1] // window[1])
    table = rand((2 * window[0] - 1) * (2 * window[1] - 1), heads, scale=0.1)
    rel = torch.from_numpy(window_attn.relative_position_index(window)).to(dev)
    mask = (torch.from_numpy(window_attn.shifted_window_mask(
        *grid, window, 2)).to(dev) if shifted else None)
    lin = c ** -0.5
    ws = (torch.cat([rand(2 * c, c, scale=0.05 * lin), rand(c, c, scale=lin)]),
          rand(3 * c, scale=0.1), rand(c, c, scale=lin), rand(c, scale=0.1))
    am = window_attn.additive_matrix(heads, n, table, rel, mask)
    return rand(nbw, n, c), ws, table, dict(rel_index=rel, mask=mask), am


def memory_mb(fn):
    """``fn()``'s result, the device memory still allocated after it beyond
    what was live before it (what the result holds), and the peak above
    that base during the call (its outputs included), in MB."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return (out, (torch.cuda.memory_allocated() - base) / 1e6,
            (torch.cuda.max_memory_allocated() - base) / 1e6)


def k4_bwd_core_check(checks: Checks, label, x, ws, am, heads):
    """K4 backward's attention kernel against its plain version, on the
    qkv and do that its caller computes; returns the kernel's inputs."""
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    nbw, n, c = x.shape
    scale = (c // heads) ** -0.5
    qkv = K.linear(x.reshape(-1, c), ws[0], ws[1])
    do = K.linear(x.flip(0).reshape(-1, c), ws[2].t().contiguous())
    args = (qkv, do, am, n, heads, scale)
    mask = am.repeat(nbw // am.shape[0], 1, 1, 1)
    checks.compare("wa_attention_bwd", label,
                   lambda: K.window_attention_bwd_core(*args),
                   lambda: K.window_attention_bwd_core_plain(*args),
                   (f32_tol,) * 3, "dqkv, o, d_addmask 1e-4 x max(1,|plain|)",
                   inputs=(qkv, do, am), ops=attn(nbw, heads, n, c // heads,
                                                  products=6),
                   library=sdpa_bwd(qkv, do, n, heads, scale, mask),
                   library_text="SDPA's backward alone to q, k, v, the additive "
                                "matrix a constant")
    return args


def past_l2(tensors, mb: float = 100.0):
    """Copies of ``tensors`` enough that reading them in turn moves more
    than ``mb`` MB (past the 50 MB L2, as the train step finds them); the
    first set is the tensors themselves."""
    import math
    n = sum(t.numel() * t.element_size() for t in tensors)
    sets = max(1, math.ceil(mb * 1e6 / n))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(sets - 1)]


def k4_bwd_core_device(core, where) -> None:
    """K4 backward's attention kernel as device time a call back to back
    over input copies past the L2, beside its byte bound."""
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    qkv, do, am, n, heads, scale = core
    sets = past_l2((qkv, do))
    ms = back_to_back_ms([lambda s=s: K.window_attention_bwd_core(
        s[0], s[1], am, n, heads, scale) for s in sets])
    bound = 1e3 * 2 * (qkv.numel() + do.numel()) * 4 / HBM_BYTES_S
    log(f"    wa_attention_bwd device ms a call, back to back past the L2 "
        f"({len(sets)} input sets): {ms:.4f} (bound {bound:.4f}, "
        f"{100 * bound / ms:.0f}%), {where}")


def k4_wgrad_check(checks: Checks, where, core) -> None:
    """K4 backward's weight-gradient kernel (``wa_wgrad``) against its plain
    version on the attention kernel's dqkv and context, with x2 and g2 f32
    and upcast from bf16 (its lo pass dropped under the claims, bit-equal to
    three passes); two calls bit-equal; device time a call back to back past
    the L2 beside today's (d)+(e) in torch.matmul, which no one call
    replaces."""
    import torch
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    qkv, do, am, n, heads, scale = core
    dqkv, o, _ = K.window_attention_bwd_core(*core)
    rows, c = o.shape
    g = torch.Generator(device=o.device).manual_seed(rows)
    x2 = torch.randn(rows, c, generator=g, device=o.device)
    g2 = torch.randn(rows, c, generator=g, device=o.device)
    ops = [mm(c, 3 * c, rows, PEAK_F32_MM), mm(c, c, rows, PEAK_F32_MM)]
    text = "d_qkv_w, d_qkv_b, d_proj_w, d_proj_b 1e-4 x max(1,|plain|)"
    ones = torch.ones(rows, device=o.device)
    for dname in ("f32", "bf16"):
        if dname == "bf16":
            x2, g2 = x2.to(torch.bfloat16).float(), g2.to(torch.bfloat16).float()
        claims = dict(x_tf32=dname == "bf16", g_tf32=dname == "bf16")
        args = (dqkv, x2, g2, o)
        row = checks.compare(
            "wa_wgrad", f"K4 weight gradients, {where} {dname}",
            lambda: K.window_attention_wgrad(*args, **claims),
            lambda: K.window_attention_wgrad_plain(*args),
            (f32_tol,) * 4, text, inputs=args, ops=ops, library=None,
            library_text="no one call gives the four; today's (d)+(e) below")
        a = K.window_attention_wgrad(*args, **claims)
        b = K.window_attention_wgrad(*args, **claims)
        same = all(torch.equal(u, v) for u, v in zip(a, b))
        three = all(torch.equal(u, v) for u, v in zip(
            a, K.window_attention_wgrad(*args)))
        sets = past_l2(args)
        ms = back_to_back_ms([lambda s=s: K.window_attention_wgrad(*s, **claims)
                              for s in sets])
        lib = back_to_back_ms([lambda s=s: (s[2].t() @ s[3], s[0].t() @ s[1],
                                            ones @ s[0], ones @ s[2])
                               for s in sets])
        log(f"    wa_wgrad {dname}: two calls {'bit-equal' if same else 'DIFFER'}"
            + (f", two passes {'bit-equal to' if three else 'DIFFER from'} three"
               if dname == "bf16" else "")
            + f"; device ms a call, back to back past the L2 ({len(sets)} input "
              f"sets): {ms:.4f} (bound {row['bound_ms']:.4f}, "
              f"{100 * row['bound_ms'] / ms:.0f}%); today's (d)+(e) in "
              f"torch.matmul {lib:.4f}")
        require(same and (dname == "f32" or three),
                f"wa_wgrad {where} {dname}: two calls differ or the dropped "
                f"lo pass changed the bits")
        del sets
    del dqkv, o, x2, g2


def aten_ops(fn):
    """The aten operators ``fn()`` dispatches (kernel launches through the
    port's C entry points are not among them)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Record():
        fn()
    return seen


def k4_bwd_split(x, ws, am, heads, go) -> None:
    """The time of each step of K4's backward on the card (ops/kernels.
    _window_attention_bwd) at one shape, and of the whole call."""
    import torch
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    nbw, n, c = x.shape
    scale = (c // heads) ** -0.5
    qkv_w, qkv_b, proj_w = ws[:3]
    x2, g2 = x.reshape(-1, c).float(), go.reshape(-1, c).float().contiguous()
    qkv = K.linear(x2, qkv_w, qkv_b)
    do = K.linear(g2, proj_w.t().contiguous())
    dqkv, o, _ = K.window_attention_bwd_core(qkv, do, am, n, heads, scale)
    x_tf32, g_tf32 = x.dtype == torch.bfloat16, go.dtype == torch.bfloat16
    ones = torch.ones(x2.shape[0], device=x.device)
    steps = {
        "a qkv (wa_linear)": lambda: K.linear(x2, qkv_w, qkv_b, a_tf32=x_tf32),
        "b do (transpose + wa_linear)": lambda: K.linear(
            g2, proj_w.t().contiguous(), a_tf32=g_tf32),
        "c core (wa_attention_bwd)": lambda: K.window_attention_bwd_core(
            qkv, do, am, n, heads, scale),
        "d weight and bias gradients (wa_wgrad)": lambda: K.window_attention_wgrad(
            dqkv, x2, g2, o, x_tf32=x_tf32, g_tf32=g_tf32),
        "  the same in torch.matmul (the parent's d, e)": lambda: (
            g2.t() @ o, dqkv.t() @ x2, ones @ dqkv, ones @ g2),
        "e dx (transpose + wa_linear)": lambda: K.linear(
            dqkv, qkv_w.t().contiguous(), out_dtype=x.dtype),
        "whole window_attention_bwd": lambda: K.window_attention_bwd(
            x, qkv_w, qkv_b, proj_w, am, go, heads, scale),
        "its PyTorch body (window_attention_bwd_plain)":
            lambda: K.window_attention_bwd_plain(x, qkv_w, qkv_b, proj_w, am,
                                                 go, heads, scale)}
    log(f"  K4 backward steps, nBW{nbw} N{n} C{c} h{heads} {x.dtype} "
        f"(CUDA-event medians):")
    for name, fn in steps.items():
        log(f"    {name:46s} {time_ms(fn):.4f} ms")
    del qkv, do, dqkv, o
    torch.cuda.empty_cache()


def k4_forward_kernels(checks: Checks, where, x, ws, am, heads,
                       first: bool) -> None:
    """K4's two forward kernels at a Swin stage's shape (``x`` f32): the
    per-window core (``wa_window_fwd``) against its plain version beside
    SDPA f32 with the additive matrix as its attn_mask; wa_linear for the
    qkv and the proj products on the schedule linear_plan picks (the narrow
    one's rows named ``wa_linear_narrow``) against linear_plain beside
    F.linear f32 (TF32 off); each also as device time a call back to back;
    the narrow schedule's qkv product of an A upcast from bf16 without its
    A_lo pass, bit-equal to the three-pass one, both timed; at ``first``
    the core's two calls bit-equal."""
    import torch
    import torch.nn.functional as F
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    nbw, n, c = x.shape
    scale = (c // heads) ** -0.5
    x2 = x.reshape(-1, c)
    qkv = K.linear(x2, ws[0], ws[1])
    mask = am.repeat(nbw // am.shape[0], 1, 1, 1)
    args = (qkv, n, heads, scale)
    checks.compare("wa_window_fwd", f"K4 core, {where}",
                   lambda: K.attention_core(*args, addmask=am),
                   lambda: K.attention_core_plain(*args, addmask=am),
                   f32_tol, "1e-4 x max(1,|plain|)", inputs=(qkv, am),
                   ops=attn(nbw, heads, n, c // heads),
                   library=lambda: sdpa(qkv, n, heads, scale, mask),
                   library_text="SDPA f32, the additive matrix as attn_mask")
    ctx = K.attention_core(*args, addmask=am)
    if first:
        same = torch.equal(ctx, K.attention_core(*args, addmask=am))
        log(f"  wa_window_fwd two calls: the context "
            f"{'bit-equal' if same else 'DIFFERS'}")
        require(same, "wa_window_fwd: two calls on the same inputs differ")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    for what, a, w, b in (("qkv", x2, ws[0], ws[1]), ("proj", ctx, ws[2], ws[3])):
        m, k = a.shape
        grid = K.linear_plan(m, w.shape[0], k, torch.float32, sms)
        row = checks.compare(
            "wa_linear_narrow" if grid else "wa_linear",
            f"K4 {what} {m}x{w.shape[0]}x{k} {'narrow' if grid else '128x128'}, {where}",
            lambda: K.linear(a, w, b), lambda: K.linear_plain(a, w, b),
            f32_tol, "1e-4 x max(1,|plain|)", inputs=(a, w, b),
            ops=mm(m, w.shape[0], k, PEAK_F32_MM),
            library=lambda: F.linear(a, w, b), library_text="F.linear f32, TF32 off")
        log(f"    device ms a call, back to back: {back_to_back_ms([lambda: K.linear(a, w, b)]):.4f} "
            f"(bound {row['bound_ms']:.4f})")
    log(f"    core device ms a call, back to back: "
        f"{back_to_back_ms([lambda: K.attention_core(*args, addmask=am)]):.4f}")
    # the qkv product of an A upcast from bf16 on the narrow schedule, with
    # and without its A_lo pass (as under a bf16 x, where linear_plan may
    # also pick it for the two passes alone)
    a16 = x2.to(torch.bfloat16).float()
    rows, cols = a16.shape[0], ws[0].shape[0]
    bm, bn = K.NARROW_TILE
    grid = min(-(-rows // bm) * -(-cols // bn), K.NARROW_BLOCKS_PER_SM * sms)
    lib = K.build()

    def narrow(a_tf32):
        out = torch.empty((rows, cols), device=x.device)
        rc = lib.wa_linear(K._ptr(a16), K._ptr(ws[0]), K._ptr(ws[1]), None, 0,
                           K._ptr(out), 0, rows, cols, c, 0, a_tf32, grid, K._stream())
        require(rc == 0, f"wa_linear narrow: cudaError {rc}")
        return out
    three, two = narrow(0), narrow(1)
    same = torch.equal(three, two)
    ms3 = back_to_back_ms([lambda: narrow(0)])
    ms2 = back_to_back_ms([lambda: narrow(1)])
    log(f"  wa_linear_narrow qkv {rows}x{cols}x{c} of a bf16-origin A: A_lo pass dropped "
        f"{'bit-equal to' if same else 'DIFFERS from'} three passes; device "
        f"{ms2:.4f} ms against {ms3:.4f} ms a call, back to back")
    require(same, f"wa_linear a_tf32 at {where}: not bit-equal to three passes")
    del qkv, ctx, mask, a16, three, two


def phase_swin_k4(checks: Checks, dev, rand) -> None:
    """K4 at the Swin's four stage shapes at b64 (stage 1: 4,096 windows of
    4x5 tokens, C 96, 3 heads, the bias table and the 64-window shift
    mask): its two forward kernels (``k4_forward_kernels``) and the whole
    forward against its plain version, f32 and bf16 x; its backward's
    attention kernel against its plain version and the whole backward
    against autograd of the plain version, f32 and bf16 x; at stage 1 the
    kernels' determinism, the backward's steps and its memory beside the
    plain route's."""
    import torch
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    for stage in range(len(SWIN_STAGES)):
        xs, ws, table, skw, am = swin_stage_inputs(dev, rand, stage)
        nbw, n, cs = xs.shape
        hs = SWIN_STAGES[stage][3]
        scale = (cs // hs) ** -0.5
        where = (f"Swin stage {stage + 1} nBW{nbw} N{n} C{cs} h{hs} "
                 f"{'mask' if skw['mask'] is not None else 'bias'}")
        k4_forward_kernels(checks, where, xs, ws, am, hs, stage == 0)
        core = k4_bwd_core_check(checks, f"K4 backward core, {where}", xs, ws,
                                 am, hs)
        k4_bwd_core_device(core, where)
        k4_wgrad_check(checks, where, core)
        if stage == 0:
            a = K.window_attention_bwd_core(*core)
            b = K.window_attention_bwd_core(*core)
            same = torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
            log(f"  wa_attention_bwd two calls: dqkv and d_addmask "
                f"{'bit-equal' if same else 'DIFFER'}")
            require(same, "wa_attention_bwd: two calls on the same inputs differ")
            del a, b
        del core
        for dt, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x = xs.to(dt)
            args = (x, *ws, table)
            fargs = (xs, *ws)
            f32 = dname == "f32"
            tol, text = ((f32_tol, "1e-4 x max(1,|plain|)") if f32
                         else (bf16_quanta(1), "1 bf16 quantum of max|plain|"))
            # the forward's bf16 output at stages 2-4: 2 quanta of max|plain|,
            # what one rounding flip of an element in max's binade can reach
            # (at stage 4 max|plain| is 1.86, a flip there 2^-7); stage 1's
            # row keeps its 1 quantum
            ftol, ftext = ((bf16_quanta(2), "2 bf16 quanta of max|plain|")
                           if stage and not f32 else (tol, text))
            checks.compare("window_attention", f"K4 {where} {dname}",
                           lambda: K.window_attention(*args[:5], hs,
                                                      bias_table=table, **skw),
                           lambda: K.window_attention_plain(
                               *args[:5], hs, bias_table=table, **skw),
                           ftol, ftext, inputs=(*args[:5], am),
                           ops=window_ops(nbw, n, cs, hs),
                           library=mha(*fargs, hs, scale, am),
                           library_text="F.multi_head_attention_forward f32, its "
                                        "own d^-0.5" + ("" if f32 else ", on x "
                                                        "upcast beforehand"))
            go = rand(nbw, n, cs, dtype=dt)
            grads = (tol,) + (f32_tol,) * 5
            label = ("K4 backward, same, " + dname if stage == 0
                     else f"K4 backward, {where} {dname}")
            fused, fused_held, _ = memory_mb(
                lambda: k4_grads(K.window_attention_fused, args, hs, skw, go))
            plain, plain_held, _ = memory_mb(
                lambda: k4_grads(K.window_attention_plain, args, hs, skw, go))
            checks.compare("window_attention", label, fused, plain,
                           grads, f"dx {text}; d_qkv_w, d_qkv_b, d_proj_w, d_proj_b, "
                                  f"d_table 1e-4 x max(1,|plain|)",
                           inputs=(*args, go), ops=window_bwd_ops(nbw, n, cs, hs),
                           library=mha_bwd(fargs, hs, scale, am, go.float()),
                           library_text="autograd.grad of F.multi_head_attention_forward "
                                        "f32 alone, to x and the four projections")
            if stage == 0:
                peaks = [memory_mb(fn)[2] for fn in (fused, plain)]
                log(f"  K4 memory, {dname}: the forward keeps {fused_held:.1f} MB "
                    f"(kernel route) / {plain_held:.1f} MB (plain route) for "
                    f"the backward, whose peak extra memory is {peaks[0]:.1f} / "
                    f"{peaks[1]:.1f} MB")
                k4_bwd_split(x, ws, am, hs, go)
                called = aten_ops(lambda: K.window_attention_bwd(
                    x, *ws[:3], am, go, hs, scale))
                products = sorted({op for op in called if op in (
                    "mm", "addmm", "matmul", "bmm", "mv", "dot", "baddbmm")})
                log(f"  K4 backward {dname}: aten ops {sorted(set(called))}; "
                    f"no product among them: {not products}")
                require(not products, f"K4 backward {dname}: the weight "
                                      f"gradients ran in torch: {products}")
            del x, go, fused, plain
        del xs, ws, table, am
        torch.cuda.empty_cache()


def retime_r4_r9(dev, seed: int) -> dict:
    """ROADMAP R4 and R9, re-timed as device time a call back to back over
    input copies read in turn past the 50 MB L2 (as K2's rows are):
    ``tb_layer_norm`` (bf16 -> bf16) beside ``F.layer_norm`` (its weights
    in bf16) at K1's [5120, 512] and the ViT's [10240, 1280], and K6 on
    [32, 256, 80] labels.  Each row's share of its byte bound decides the
    item by the rule "half of its bound and no slower than the library
    call" (K6 has no library call)."""
    import math
    import torch
    import torch.nn.functional as F
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cpu").manual_seed(seed + 17)
    log("phase 2 (R4, R9): tb_layer_norm and K6 back to back, past the L2")
    out = {}

    def copies(t):
        return [t.clone() for _ in range(max(2, math.ceil(
            100e6 / (t.numel() * t.element_size()))))]

    for rows, c in ((5120, 512), (10240, 1280)):
        x = torch.randn(rows, c, generator=g).to(dev, torch.bfloat16)
        w = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
        b = (0.1 * torch.randn(c, generator=g)).to(dev)
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        xs = copies(x)
        ms = back_to_back_ms([lambda xi=xi: K.layer_norm(xi, w, b, 1e-6,
                                                         torch.bfloat16)
                              for xi in xs])
        lib = back_to_back_ms([lambda xi=xi: F.layer_norm(xi, (c,), wb, bb, 1e-6)
                               for xi in xs])
        bound = 1e3 * (2 * x.numel() * 2 + 2 * c * 4) / HBM_BYTES_S
        ok = ms <= 2 * bound and ms <= lib
        out[f"tb_layer_norm [{rows},{c}]"] = dict(ms=ms, library_ms=lib,
                                                  bound_ms=bound)
        log(f"  tb_layer_norm [{rows},{c}] bf16: device {ms:.4f} ms a call, "
            f"F.layer_norm {lib:.4f} ms; byte bound {bound:.4f} ms, "
            f"{bound / ms:.0%} of it; rule (>= 50% and <= library): "
            f"{'close' if ok else 'redesign'}")
    lab = (torch.rand(TRAIN_BATCH["transunet"], 256, 80, generator=g) * 2.3
           - 0.1).to(dev)
    labs = copies(lab)
    ms = back_to_back_ms([lambda li=li: K.label2vec_smooth(li, 0.1)
                          for li in labs])
    bound = 1e3 * (lab.numel() * 4 * 4) / HBM_BYTES_S
    out["label2vec_smooth [32,256,80]"] = dict(ms=ms, library_ms=None,
                                               bound_ms=bound)
    log(f"  label2vec_smooth [32,256,80]: device {ms:.4f} ms a call; byte "
        f"bound {bound:.4f} ms, {bound / ms:.0%} of it (no library call); "
        f"rule (>= 50%): {'close' if ms <= 2 * bound else 'redesign'}")
    return out


def phase_vit_kernels(checks: Checks, dev, seed: int) -> None:
    """The kernels at the ViT's shapes (K1, K4), K5 at the ViT and
    TransUNet train shapes, and K6, against their plain versions."""
    import torch
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cpu").manual_seed(seed + 11)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    bf = torch.bfloat16
    log("phase 2 (ViT shapes, K5, K6): kernels vs plain PyTorch on the card")
    # K5 forward: out, saved qkv and P, at the ViT b8 and TransUNet b32
    # train shapes; q/k kernels damped as in random_flax_variables
    for b, n, c, heads in ((8, 160, 1280, 8), (32, 80, 512, 4)):
        lin = c ** -0.5
        xw = rand(b * n, c)
        ws = (torch.cat([rand(2 * c, c, scale=0.05 * lin), rand(c, c, scale=lin)]),
              rand(3 * c, scale=0.1), rand(c, c, scale=lin), rand(c, scale=0.1))
        for dt, dname in ((torch.float32, "f32"), (bf, "bf16")):
            args = (xw.to(dt), ws[0].to(dt), ws[1].to(dt).float(), ws[2].to(dt),
                    ws[3].to(dt).float(), n, heads, heads ** -0.5)
            tol, text = ((f32_tol, "1e-4 x max(1,|plain|)") if dname == "f32"
                         else (bf16_quanta(2), "2 bf16 quanta"))
            label = f"K5 b{b} N{n} C{c} h{heads} {dname}"
            pk = PEAK_F32_MM if dname == "f32" else PEAK_BF16
            checks.compare("attention_train", label,
                           lambda: K.attention_train_fwd(*args),
                           lambda: K.attention_train_fwd_plain(*args),
                           (tol, tol, tol), f"out, qkv, P {text}", inputs=args[:5],
                           ops=[mm(b * n, 3 * c, c, pk), mm(b * n, c, c, pk),
                                *attn(b, heads, n, c // heads)],
                           library_text="no one call also returns the saved P "
                                        "and qkv")
            if b == 8:
                cargs = (K.linear_plain(*args[:3]), n, heads, heads ** -0.5, dt)
                checks.compare("at_attention_core", f"b{b} S{n} h{heads} "
                               f"d{c // heads} {dname}",
                               lambda: K.attention_train_core(*cargs),
                               lambda: K.attention_train_core_plain(*cargs),
                               (f32_tol, tol, tol),
                               f"ctx (float32) 1e-4 x max(1,|plain|); qkv, P {text}",
                               inputs=cargs[:1], ops=attn(b, heads, n, c // heads),
                               library_text="SDPA does not return P")
    # K1's and K4's attention cores at the ViT serving shape: batch 64 x 160
    # tokens, C 1280, 8 heads (head dim 160)
    b, s, c, heads, mlp = BATCH, 160, 1280, 8, 2048
    eps, scale, lin = 1e-6, 8 ** -0.5, c ** -0.5
    qkv = torch.cat([rand(b * s, 2 * c, scale=0.3), rand(b * s, c)], dim=1)
    qkv_bf = qkv.to(bf)   # SDPA's bf16 operands, rounded once, untimed
    checks.compare("tb_attention_core", "ViT b64 S160 h8 d160 P,V bf16",
                   lambda: K.attention_core(qkv, s, heads, scale, pv_bf16=True,
                                            out_dtype=bf),
                   lambda: K.attention_core_plain(qkv, s, heads, scale, pv_bf16=True,
                                                  out_dtype=bf),
                   bf16_quanta(2), "2 bf16 quanta", inputs=(qkv,),
                   ops=attn(b, heads, s, c // heads, PEAK_BF16),
                   library=lambda: sdpa(qkv_bf, s, heads, scale),
                   library_text="SDPA bf16 on q, k, v rounded to bf16 "
                                "beforehand (half the kernel's input bytes)")
    checks.compare("wa_attention_core", "ViT b64 S160 h8 d160 f32",
                   lambda: K.attention_core(qkv, s, heads, scale),
                   lambda: K.attention_core_plain(qkv, s, heads, scale),
                   f32_tol, "1e-4 x max(1,|plain|)", inputs=(qkv,),
                   ops=attn(b, heads, s, c // heads),
                   library=lambda: sdpa(qkv, s, heads, scale),
                   library_text="SDPA f32 on the same q, k, v")
    del qkv, qkv_bf
    # K1 at the ViT serving shape
    w = K.BlockWeights(
        1 + rand(c, scale=0.1), rand(c, scale=0.1),
        torch.cat([rand(2 * c, c, scale=lin * 0.05), rand(c, c, scale=lin)]).to(bf),
        rand(3 * c, scale=0.1), rand(c, c, scale=lin, dtype=bf),
        rand(c, scale=0.1), 1 + rand(c, scale=0.1), rand(c, scale=0.1),
        rand(mlp, c, scale=lin, dtype=bf), rand(mlp, scale=0.1),
        rand(c, mlp, scale=mlp ** -0.5, dtype=bf), rand(c, scale=0.1))
    x = rand(b, s, c, dtype=bf)
    fin = (1 + rand(c, scale=0.1), rand(c, scale=0.1))
    checks.compare("transformer_block", "K1 ViT b64 S160 C1280 h8 bf16",
                   lambda: K.transformer_block(x, w, heads, scale, eps),
                   lambda: K.transformer_block_plain(x, w, heads, scale, eps),
                   bf16_quanta(4), "4 bf16 quanta of max|plain|",
                   inputs=(x, *w), ops=block_ops(b, s, c, heads, mlp),
                   library_text=K1_NONE)
    checks.compare("transformer_block", "K1 ViT same, folded final LN",
                   lambda: K.transformer_block(x, w, heads, scale, eps, fin),
                   lambda: K.transformer_block_plain(x, w, heads, scale, eps, fin),
                   bf16_quanta(4), "4 bf16 quanta of max|plain|",
                   inputs=(x, *w, *fin), ops=block_ops(b, s, c, heads, mlp),
                   library_text=K1_NONE)
    del x, w
    # K4 at the ViT f32 serving shape: 64 windows of 160 tokens, no bias
    xf = rand(b, s, c)
    args = (xf, torch.cat([rand(2 * c, c, scale=lin * 0.05), rand(c, c, scale=lin)]),
            rand(3 * c, scale=0.1), rand(c, c, scale=lin), rand(c, scale=0.1), heads)
    checks.compare("window_attention", "K4 ViT b64 N160 C1280 h8 f32",
                   lambda: K.window_attention(*args, scale=scale),
                   lambda: K.window_attention_plain(*args, scale=scale),
                   f32_tol, "1e-4 x max(1,|plain|)", inputs=args[:5],
                   ops=window_ops(b, s, c, heads), library=mha(*args, scale),
                   library_text="F.multi_head_attention_forward, q weights "
                                "pre-scaled")
    del xf, args
    # K6 on a train batch's labels, straddling the 0.95 / 1.05 thresholds
    lab = torch.rand(TRAIN_BATCH["transunet"], 256, 80, generator=g).to(dev) * 2.3 - 0.1
    for sm in (0.0, 0.1):
        checks.compare("label2vec_smooth", f"K6 [32,256,80] smoothing {sm}",
                       lambda: K.label2vec_smooth(lab, sm),
                       lambda: K.label2vec_smooth_plain(lab, sm),
                       lambda want: 0.0, "exact", inputs=(lab,),
                       ops=elementwise(lab.numel(), 6),
                       library_text="no one call maps a label to the smoothed "
                                    "3-class vector")


def phase_gemm(checks: Checks, dev, seed: int) -> None:
    """``tb_linear`` and ``wa_linear`` at the ViT's shapes: serving b64 (M
    10240; K1's four products in bf16, K4's two in f32) and the K5 train
    shape b8 (M 1280), against their plain versions, each beside
    ``F.linear`` on the same operands; then the host's time to enqueue one
    call."""
    import torch
    import torch.nn.functional as F
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    g = torch.Generator(device="cpu").manual_seed(seed + 13)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    bf, f32 = torch.bfloat16, torch.float32
    log("phase 2 (GEMMs): tb_linear / wa_linear at the ViT shapes")
    c, mlp = 1280, 2048
    # (label, M, N, K, operand dtype, GELU, residual dtype, output dtype)
    rows = [("K1 ViT b64 qkv", 10240, 3 * c, c, bf, False, None, f32),
            ("K1 ViT b64 proj +res", 10240, c, c, bf, False, f32, f32),
            ("K1 ViT b64 fc1 GELU", 10240, mlp, c, bf, True, None, bf),
            ("K1 ViT b64 fc2 +res", 10240, c, mlp, bf, False, f32, bf),
            ("K4 ViT b64 qkv", 10240, 3 * c, c, f32, False, None, f32),
            ("K4 ViT b64 proj", 10240, c, c, f32, False, None, f32),
            ("K5 ViT b8 qkv", 1280, 3 * c, c, bf, False, None, f32),
            ("K5 ViT b8 proj", 1280, c, c, bf, False, None, bf),
            ("K5 ViT b8 qkv", 1280, 3 * c, c, f32, False, None, f32),
            ("K5 ViT b8 proj", 1280, c, c, f32, False, None, f32)]
    for label, m, n, k, dt, gelu, res_dt, out_dt in rows:
        a = rand(m, k, dtype=dt)
        w = rand(n, k, scale=k ** -0.5, dtype=dt)
        b = rand(n, scale=0.1)
        r = None if res_dt is None else rand(m, n, dtype=res_dt)
        b_dt = b.to(dt)
        name = "tb_linear" if dt == bf else "wa_linear"
        tol, text = ((f32_tol, "1e-4 x max(1,|plain|)") if out_dt == f32
                     else (bf16_quanta(2), "2 bf16 quanta"))
        if gelu or r is not None or out_dt != dt:
            lib_text = (f"F.linear {'bf16' if dt == bf else 'f32'} alone, without "
                        f"the fused epilogue")
        else:
            lib_text = f"F.linear {'bf16' if dt == bf else 'f32, TF32 off'}"
        row = checks.compare(
            name, f"{label} {m}x{n}x{k} ->{'bf16' if out_dt == bf else 'f32'}",
            lambda: K.linear(a, w, b, gelu=gelu, residual=r, out_dtype=out_dt),
            lambda: K.linear_plain(a, w, b, gelu=gelu, residual=r, out_dtype=out_dt),
            tol, text, inputs=(a, w, b, r),
            ops=mm(m, n, k, PEAK_BF16 if dt == bf else PEAK_F32_MM),
            library=lambda: F.linear(a, w, b_dt), library_text=lib_text)
        if name == "wa_linear":
            log_beside_recorded(row, m, n, k, lambda: K.linear(a, w, b, gelu=gelu, residual=r,
                                                          out_dtype=out_dt))
        del a, w, r
    # the host's share of a launch: wrapper checks, two tensor maps encoded
    # (cuTensorMapEncodeTiled), the launch; a tiny product, so the queue
    # never fills
    a, w, b = rand(128, 64, dtype=bf), rand(128, 64, dtype=bf), rand(128)
    b_bf = b.to(bf)
    host = {}
    for what, fn in (("K.linear", lambda: K.linear(a, w, b)),
                     ("F.linear", lambda: F.linear(a, w, b_bf))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        host[what] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    log(f"  host time to enqueue one call (128x128x64 bf16, mean of 500): "
        f"K.linear {host['K.linear']:.1f} us, F.linear {host['F.linear']:.1f} us")


def seeded_model(family: str, seed: int, dtype: str = "f32",
                 attn_train_impl: str = "xla", num_classes: int = 3):
    """The family's default-config model with seeded random flax-layout
    weights (q/k kernels damped), loaded through the bridge; returns
    (model, flat flax dict)."""
    import dataclasses
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.models.registry import build_model
    from ultrasound_modeling_tpu_torch.utils.checkpoint import (
        from_flax, random_flax_variables)

    mcfg = dataclasses.replace(
        default_config(family).model,
        compute_dtype="bfloat16" if dtype == "bf16" else "float32",
        attn_train_impl=attn_train_impl, num_classes=num_classes)
    model = build_model(mcfg)
    flat = random_flax_variables(model, seed)
    model.load_state_dict(from_flax(flat, model.family), strict=True)
    return model, flat


def phase_forward(dev, seed: int, batch: int, family: str, phase: str):
    """Full-width forward, kernel vs all-plain path, f32 and bf16."""
    import numpy as np
    import torch
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    log(f"phase {phase}: full-width {family} forward, batch {batch}")
    model, flat = seeded_model(family, seed)
    model = model.eval().to(dev)
    # (K1, K4) calls a forward makes: the transformer families run K1 in
    # every layer under bf16 and K4 under f32; the Swin K4 in every block
    layers = sum(type(m).__name__ == "Block" for m in model.modules())
    windows = sum(type(m).__name__ == "WindowAttention" for m in model.modules())
    # K2's eval norm: both branches of each split-attention stage
    norms = 2 * sum(type(m).__name__ == "ResidualS" for m in model.modules())
    want = ({"f32": (0, windows), "bf16": (0, windows)} if family == "swin"
            else {"f32": (0, layers), "bf16": (layers, 0)})
    x = np.random.default_rng(seed + 1).standard_normal(
        (batch, 256, 80, 10)).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    outs = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        model.compute_dtype = dt
        for impl in ("kernel", "plain"):
            with torch.inference_mode(), K.plain_versions(impl == "plain"):
                K.reset_launch_counts()
                p = model(xt)
                torch.cuda.synchronize()
                counts = dict(K.LAUNCHES)
                reps = 5
                t0 = time.perf_counter()
                for _ in range(reps):
                    model(xt)
                torch.cuda.synchronize()
                fps = reps * batch / (time.perf_counter() - t0)
            require(p.shape == (batch, 256, 80, 3) and p.dtype == torch.float32,
                    f"{name}/{impl}: output {tuple(p.shape)} {p.dtype}")
            require(torch.isfinite(p).all(), f"{name}/{impl}: non-finite")
            sum_err = (p.sum(-1) - 1).abs().max().item()
            require(sum_err < 1e-4, f"{name}/{impl}: probs sum off by {sum_err}")
            if impl == "kernel":
                want_k1, want_k4 = want[name]
                require(counts["transformer_block"] == want_k1,
                        f"{name}: K1 launches {counts}, want {want_k1}")
                require(counts["window_attention"] == want_k4,
                        f"{name}: K4 launches {counts}, want {want_k4}")
                require(counts["group_flat_norm"] == counts[
                    "group_flat_norm_fwd"] == norms,
                        f"{name}: K2 eval launches {counts}, want {norms}")
            else:
                require(all(v == 0 for v in counts.values()),
                        f"{name}: plain path launched kernels {counts}")
            log(f"  {name:4s} {impl:6s} {fps:10.1f} frames/s  "
                f"prob-sum err {sum_err:.2e}  launches {counts}")
            outs[(name, impl)] = p
    d32 = (outs[("f32", "kernel")] - outs[("f32", "plain")]).abs().max().item()
    log(f"  f32 kernel vs plain: max abs prob diff {d32:.3e} (bound 1e-4)")
    require(d32 <= 1e-4, f"f32 kernel vs plain: {d32} > 1e-4")
    kb, pb = outs[("bf16", "kernel")], outs[("bf16", "plain")]
    dbf = (kb - pb).abs().max().item()
    agree = (kb.argmax(-1) == pb.argmax(-1)).float().mean().item()
    log(f"  bf16 kernel vs plain: max abs prob diff {dbf:.3e} (bound 0.05), "
        f"argmax agreement {agree:.6f} (bound 0.99)")
    require(dbf <= 0.05 and agree >= 0.99,
            f"bf16 kernel vs plain: diff {dbf}, argmax agreement {agree}")
    del model
    torch.cuda.empty_cache()
    return x, {k: v[:8].cpu().numpy() for k, v in outs.items()}, flat


def family_batch(family: str, n: int, seed: int):
    """(frames, labels) of ``n`` synthetic frames at the family's shape."""
    import numpy as np
    import torch
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.data import synthetic

    mc = default_config(family).model
    raw = synthetic.make_raw_array(n, seed, *mc.img_size, mc.in_channels)
    return (torch.from_numpy(np.ascontiguousarray(raw[:, 0, :, :, 1:-1])),
            torch.from_numpy(np.ascontiguousarray(raw[:, 0, :, :, 0])))


def phase_unet_forward(dev, seed: int, batch: int, family: str, phase: str):
    """Full-width forward of a family with no kernel on its path: the
    card's f32 against the port's CPU forward of the first 4 frames, bf16
    against f32 on the card; no kernel may launch."""
    import numpy as np
    import torch
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    mc = default_config(family).model
    shape = (batch, *mc.img_size, mc.in_channels)
    log(f"phase {phase}: full-width {family} forward, batch {batch}, frames "
        f"{shape[1:]}")
    model, flat = seeded_model(family, seed)
    model.eval()
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    with torch.inference_mode():
        t0 = time.perf_counter()
        cpu = model(torch.from_numpy(x[:4]))
        log(f"  CPU f32 forward of 4 frames: {time.perf_counter() - t0:.2f} s")
    model.to(dev)
    xt = torch.from_numpy(x).to(dev)
    outs = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        model.compute_dtype = dt
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            K.reset_launch_counts()
            p = model(xt)
            torch.cuda.synchronize()
            counts = {k: v for k, v in K.LAUNCHES.items() if v}
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                model(xt)
            torch.cuda.synchronize()
            fps = reps * batch / (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        require(p.shape == (*shape[:3], 3) and p.dtype == torch.float32,
                f"{family} {name}: output {tuple(p.shape)} {p.dtype}")
        require(torch.isfinite(p).all(), f"{family} {name}: non-finite")
        sum_err = (p.sum(-1) - 1).abs().max().item()
        require(sum_err < 1e-4, f"{family} {name}: probs sum off by {sum_err}")
        require(not counts, f"{family} {name}: launched kernels {counts}")
        log(f"  {name:4s} {fps:10.1f} frames/s  prob-sum err {sum_err:.2e}  "
            f"peak {peak:.0f} MiB  launches none")
        outs[(name, "kernel")] = p
    d = (outs[("f32", "kernel")][:4].cpu() - cpu).abs().max().item()
    log(f"  f32 card vs CPU (first 4 frames): max abs prob diff {d:.3e} "
        f"(bound 1e-4)")
    require(d <= 1e-4, f"{family}: f32 card vs CPU {d} > 1e-4")
    kb, kf = outs[("bf16", "kernel")], outs[("f32", "kernel")]
    dbf = (kb - kf).abs().max().item()
    agree = (kb.argmax(-1) == kf.argmax(-1)).float().mean().item()
    log(f"  bf16 vs f32 on the card: max abs prob diff {dbf:.3e} (bound "
        f"0.05), argmax agreement {agree:.6f} (bound 0.99)")
    require(dbf <= 0.05 and agree >= 0.99,
            f"{family} bf16 vs f32: diff {dbf}, argmax agreement {agree}")
    del model
    torch.cuda.empty_cache()
    return x, {k: v[:8].cpu().numpy() for k, v in outs.items()}, flat


def phase_serve(dev, x, ref, flat, tmp: str, family: str, phase: str):
    """A main path: serve from an npz, as `cli serve --model family` does,
    f32 and bf16."""
    import numpy as np
    from ultrasound_modeling_tpu_torch.infer.server import InferenceServer
    from ultrasound_modeling_tpu_torch import cli
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    log(f"phase {phase}: serve --model {family} (npz -> bridge -> model -> "
        f"InferenceServer)")
    path = os.path.join(tmp, f"{family}.npz")
    np.savez(path, **flat)
    K.reset_launch_counts()
    for name, bf16 in (("f32", False), ("bf16", True)):
        model = cli.build_serving_model(path, bf16, dev, family)
        server = InferenceServer(cli.make_forward(model, dev), x.shape[1:],
                                 host="127.0.0.1", port=0, max_batch=64,
                                 window_ms=5.0, model_name=family)
        server.start_background()
        host, port = server.address
        url = f"http://{host}:{port}"
        results, errors = {}, []

        def post(key, frames, as_json=False):
            try:
                if as_json:
                    body = json.dumps({"instances": frames.tolist()}).encode()
                    ctype = "application/json"
                else:
                    buf = io.BytesIO()
                    np.save(buf, frames)
                    body, ctype = buf.getvalue(), "application/octet-stream"
                req = urllib.request.Request(f"{url}/predict", data=body,
                                             headers={"Content-Type": ctype})
                raw = urllib.request.urlopen(req, timeout=300).read()
                results[key] = (np.asarray(json.loads(raw)["probabilities"],
                                           np.float32)
                                if as_json else np.load(io.BytesIO(raw)))
            except Exception as e:  # surfaced by the check below
                errors.append(f"{key}: {e!r}")

        jobs = [(f"single{i}", x[i], False) for i in range(4)]
        jobs += [("batch3", x[4:7], False), ("json", x[7:8], True)]
        threads = [threading.Thread(target=post, args=j) for j in jobs]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            stats = json.loads(urllib.request.urlopen(f"{url}/stats").read())
        finally:
            server.shutdown()
        require(not errors, f"{name}: failed requests {errors}")
        want = ref[(name, "kernel")]
        tol = 1e-4 if name == "f32" else 0.05
        worst = 0.0
        for key, frames, _ in jobs:
            got = results[key]
            idx = [int(key[-1])] if key.startswith("single") else (
                [4, 5, 6] if key == "batch3" else [7])
            exp = want[idx]
            got = got.reshape(exp.shape)
            require(np.isfinite(got).all(), f"{name} {key}: non-finite")
            require(np.allclose(got.sum(-1), 1.0, atol=1e-4),
                    f"{name} {key}: probabilities do not sum to 1")
            worst = max(worst, float(np.abs(got - exp).max()))
        require(worst <= tol, f"{name}: served probs off by {worst} > {tol}")
        require(stats["requests"] == len(jobs) and stats["frames"] == 8,
                f"{name}: server stats {stats}")
        log(f"  {name:4s} {len(jobs)} requests / 8 frames answered; max abs "
            f"diff to the phase-3 forward {worst:.3e} (bound {tol}); "
            f"stats {json.dumps(stats)}")
        del model
    counts = {k: K.LAUNCHES[k] for k in SERVE_KERNELS[family]}
    log(f"  main-path launches: {counts or dict(K.LAUNCHES)}")
    missing = [k for k, v in counts.items() if v == 0]
    require(not missing, f"kernels not launched on the main path: {missing}")
    require(counts or not any(K.LAUNCHES.values()),
            f"{family} has no kernel on its path, yet {dict(K.LAUNCHES)}")
    os.remove(path)
    return counts


# Leaves whose exact gradient is 0: a bias right before a train-mode
# BatchNorm (the batch mean removes it) and the attention's key bias (the
# row softmax ignores it).  Both routes return rounding noise there; phase 5
# holds them to a small share of the largest gradient instead.
ZERO_GRAD = re.compile(
    r"(decoder/block_\d/conv\d_\d|hybrid/convtmp_\d)/bias$|attn/key_bias$")
# the ResNeStUNet's: biases right before a train-mode BatchNorm, the
# per-channel branch norms and the attention's norm over the batch included
# (the MobileUNet has none); held, as phase 5 holds them in f32, to 1e-5
# of the largest gradient
ZERO_GRAD_UNET = re.compile(r"/(conv2_1_2|t_conv|shortcut_conv)/bias$"
                            r"|/(branch1|branch2|attn_dense1)_bias$")

# (family, dtype, train attention, cli flags): phase 5 runs them all, phase
# 6 the ones marked True.  The Swin has no train-attention choice: it
# trains on K4 ('k4' labels its runs; its config ignores the field)
TRAIN_RUNS = (
    ("transunet", "f32", "xla", [], True),
    ("transunet", "f32", "flash", ["--attn-train", "flash"], True),
    ("transunet", "bf16", "flash", ["--bf16", "--attn-train", "flash"], True),
    ("transunet", "f32", "pallas", ["--attn-train", "pallas"], False),
    ("vit", "f32", "xla", ["--attn-train", "xla"], False),
    ("vit", "f32", "flash", ["--attn-train", "flash"], False),
    ("vit", "f32", "pallas", ["--attn-train", "pallas"], True),
    ("vit", "bf16", "pallas", ["--bf16", "--attn-train", "pallas"], False),
    ("vit", "bf16", "flash", ["--bf16", "--attn-train", "flash"], True),
    ("swin", "f32", "k4", [], True),
    ("swin", "bf16", "k4", ["--bf16"], True))


def needed_kernels(family: str, impl: str):
    """The train kernels a step of this family and attention launches."""
    return ((K2_KERNELS if family == "transunet" else ())
            + {"flash": K3_KERNELS, "pallas": K5_KERNELS,
               "k4": K4_TRAIN_KERNELS}.get(impl, ()))


def phase_train_step(dev, seed: int):
    """One train step, kernel route vs plain route, then timed steps."""
    import numpy as np
    import torch
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.data import synthetic
    from ultrasound_modeling_tpu_torch.data.labels import label2vec
    from ultrasound_modeling_tpu_torch.models.swin import set_drop_path_generator
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    from ultrasound_modeling_tpu_torch.train import losses
    from ultrasound_modeling_tpu_torch.train.optim import Adam
    from ultrasound_modeling_tpu_torch.train.step import (
        TrainState, make_train_step)
    from ultrasound_modeling_tpu_torch.utils.checkpoint import to_flax

    log("phase 5: full-width train step at each family's batch, kernel "
        "route vs plain route")
    batches = {}
    for family in dict.fromkeys(run[0] for run in TRAIN_RUNS):
        bs = TRAIN_BATCH[family]
        raw = synthetic.make_raw_array(bs, seed + 2)
        batches[family] = (
            torch.from_numpy(np.ascontiguousarray(raw[:, 0, :, :, 1:-1])).to(dev),
            torch.from_numpy(np.ascontiguousarray(raw[:, 0, :, :, 0])).to(dev))
    step_ms = {}
    for family, dtype, impl, _, _ in TRAIN_RUNS:
        name = f"{family}/{dtype}/{impl}"
        bs = TRAIN_BATCH[family]
        x, y = batches[family]
        l2 = default_config(family).train.l2_regularization
        model, _ = seeded_model(family, seed, dtype, impl)
        model.train().to(dev)
        kernels = losses.l2_kernels(model) if l2 else []
        res = {}
        # deterministic cuDNN for the comparison: its default weight-gradient
        # algorithms sum in an order that changes from run to run; the
        # Swin's drop-path masks drawn from one generator state per route
        torch.backends.cudnn.deterministic = True
        drop = torch.Generator(device=dev)
        set_drop_path_generator(model, drop)
        for route in ("kernel", "plain"):
            model.zero_grad(set_to_none=True)
            drop.manual_seed(seed + 5)
            K.reset_launch_counts()
            with K.plain_versions(route == "plain"):
                loss = losses.cce_smooth(label2vec(y), model(x).float())
                if l2:
                    loss = loss + losses.l2_regularization(kernels, l2)
                loss.backward()
            torch.cuda.synchronize()
            counts = {k: v for k, v in K.LAUNCHES.items() if v}
            copies = dict(K.LAYOUT_COPIES)
            grads = to_flax({n: p.grad for n, p in model.named_parameters()},
                            model.family)
            res[route] = (loss.item(), grads)
            log(f"  {name:22s} {route:6s} loss {loss.item():.6f}  launches "
                f"{counts}  layout copies {copies}")
            if route == "kernel":
                need = needed_kernels(family, impl)
                require(all(counts.get(k, 0) > 0 for k in need),
                        f"{name}: kernel route did not launch {need}: {counts}")
                if impl == "k4":
                    require(counts["wa_wgrad"] == counts["wa_attention_bwd"],
                            f"{name}: wa_wgrad did not run in every K4 "
                            f"backward: {counts}")
            else:
                require(not counts, f"{name}: plain route launched {counts}")
        torch.backends.cudnn.deterministic = False
        (lk, gk), (lp, gp) = res["kernel"], res["plain"]
        require(np.isfinite(lk) and np.isfinite(lp), f"{name}: loss not finite")
        loss_rel = abs(lk - lp) / abs(lp)
        gmax = max(float(np.abs(g).max()) for g in gp.values())
        bf16 = dtype == "bf16"
        worst, worst_key = -1.0 if bf16 else 0.0, ""
        for k, g in gp.items():
            a = gk[k]
            if ZERO_GRAD.search(k):
                zbound = (1e-3 if bf16 else 1e-5) * gmax
                require(max(np.abs(a).max(), np.abs(g).max()) <= zbound,
                        f"{name} {k}: exactly-zero gradient is "
                        f"{max(np.abs(a).max(), np.abs(g).max())} > {zbound}")
                continue
            if bf16:
                cos = float((a * g).sum() / max(np.linalg.norm(a) *
                                                np.linalg.norm(g), 1e-30))
                if worst < 0 or cos < worst:
                    worst, worst_key = cos, k
            else:
                r = float(np.abs(a - g).max() / max(np.abs(g).max(), 1e-30))
                if r > worst:
                    worst, worst_key = r, k
        if bf16:
            log(f"  {name:22s} loss rel diff {loss_rel:.3e} (bound 1e-2); "
                f"worst leaf cosine {worst:.6f} at {worst_key} (bound 0.99)")
            require(loss_rel <= 1e-2 and worst >= 0.99,
                    f"{name}: loss rel {loss_rel}, cosine {worst} at {worst_key}")
        else:
            log(f"  {name:22s} loss rel diff {loss_rel:.3e} (bound 1e-5); "
                f"worst leaf max|dg|/max|g| {worst:.3e} at {worst_key} "
                f"(bound 1e-3)")
            require(loss_rel <= 1e-5 and worst <= 1e-3,
                    f"{name}: loss rel {loss_rel}, grad {worst} at {worst_key}")
        # the whole step (augmentation on), the two routes in turns
        model.zero_grad(set_to_none=True)
        state = TrainState(model, Adam(model.parameters(), 1.0), 0,
                           torch.Generator(device=dev).manual_seed(seed),
                           torch.Generator(device=dev).manual_seed(seed + 1))
        step = make_train_step(model, losses.cce_smooth, l2_scale=l2)
        per = {"kernel": [], "plain": []}
        for route in ("plain", "kernel", "kernel", "plain"):
            with K.plain_versions(route == "plain"):
                for _ in range(2):
                    step(state, x, y, 1e-4)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    step(state, x, y, 1e-4)
                torch.cuda.synchronize()
            per[route].append((time.perf_counter() - t0) / 5 * 1e3)
        ms = {r: statistics.mean(v) for r, v in per.items()}
        step_ms[name] = ms
        log(f"  {name:22s} step ms/step kernel {ms['kernel']:.2f} "
            f"({1e3 * bs / ms['kernel']:.1f} frames/s), plain "
            f"{ms['plain']:.2f} ({1e3 * bs / ms['plain']:.1f} "
            f"frames/s); turns {per}")
        del model, state, res
        torch.cuda.empty_cache()
    return step_ms


def unet_grads(family: str, seed: int, dev, dtype, x, y, masks):
    """(loss, flax-layout gradients) of the family's default loss at the
    seeded weights, in train mode with the given dropout masks, on ``dev``
    in ``dtype``."""
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.data.labels import label2vec
    from ultrasound_modeling_tpu_torch.models.common import set_dropout_masks
    from ultrasound_modeling_tpu_torch.train.loop import loss_for
    from ultrasound_modeling_tpu_torch.utils.checkpoint import to_flax

    model, _ = seeded_model(family, seed)
    model.compute_dtype = dtype
    model.to(dev, dtype).train()
    set_dropout_masks(model, {k: v.to(dev) for k, v in masks.items()})
    loss = loss_for(default_config(family).train)(
        label2vec(y.to(dev)), model(x.to(dev, dtype)))
    loss.backward()
    return loss.item(), to_flax({n: p.grad for n, p in model.named_parameters()},
                                family)


def phase_unet_train(dev, seed: int, family: str, phase: str):
    """The family's train step as its Trainer builds it, at full width and
    its batch, f32 and bf16; then card against CPU at batch 4 with the same
    dropout masks."""
    import numpy as np
    import torch
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.models.common import Dropout
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    from ultrasound_modeling_tpu_torch.train.loop import loss_for, optimizer_for
    from ultrasound_modeling_tpu_torch.train.step import (
        TrainState, make_train_step)

    tc = default_config(family).train
    bs = TRAIN_BATCH[family]
    log(f"phase {phase}: {family} train step at batch {bs} (loss {tc.loss}, "
        f"lr {tc.learning_rate}), as its Trainer builds it")
    x, y = (t.to(dev) for t in family_batch(family, bs, seed + 2))
    for name in ("f32", "bf16"):
        model, _ = seeded_model(family, seed, name)
        model.train().to(dev)
        state = TrainState(model, optimizer_for(family, tc)(model), 0,
                           torch.Generator(device=dev).manual_seed(seed),
                           torch.Generator(device=dev).manual_seed(seed + 1))
        step = make_train_step(model, loss_for(tc))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        loss, _ = step(state, x, y, tc.learning_rate)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        counts = {k: v for k, v in K.LAUNCHES.items() if v}
        require(not counts, f"{family} {name}: launched kernels {counts}")
        require(np.isfinite(loss.item()), f"{family} {name}: loss {loss}")
        bad = [n for n, p in model.named_parameters()
               if not torch.isfinite(p.grad).all()]
        require(not bad, f"{family} {name}: non-finite gradients {bad[:3]}")
        after = model.state_dict()
        stats = [k for k in after if "running" in k or k.endswith(
            ("_norm_mean", "_norm_var"))]
        still = [k for k in stats if torch.equal(after[k], before[k])]
        require(stats and not still,
                f"{family} {name}: running statistics did not move: {still}")
        moved = {}
        for n, p in model.named_parameters():
            top = "encoder" if n.split(".")[0] == "encoder" else "decoder"
            d = (p.detach() - before[n]).abs().max().item()
            moved[top] = max(moved.get(top, 0.0), d)
        ratio = ""
        if family == "mobileunet":
            r = moved["encoder"] / moved["decoder"]
            ratio = f"; encoder/decoder largest move {r:.5f} (want 0.1)"
            require(abs(r - 0.1) <= 1e-3 * 0.1,
                    f"{family} {name}: encoder/decoder move ratio {r}")
        for _ in range(2):
            step(state, x, y, tc.learning_rate)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(state, x, y, tc.learning_rate)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        log(f"  {name:4s} loss {loss.item():.6f}, {len(stats)} running "
            f"statistics moved{ratio}; {ms:.2f} ms/step ({1e3 * bs / ms:.1f} "
            f"frames/s), peak {peak:.0f} MiB, launches none")
        del model, state, step
        torch.cuda.empty_cache()

    # card against CPU at batch 4, the same dropout masks
    x4, y4 = family_batch(family, 4, seed + 3)
    model, _ = seeded_model(family, seed)
    shapes = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, n=n: shapes.__setitem__(n, tuple(inp[0].shape)))
        for n, m in model.named_modules() if isinstance(m, Dropout)]
    with torch.no_grad():
        model.eval()(x4)
    for h in hooks:
        h.remove()
    rng = np.random.default_rng(seed + 4)
    masks = {n: torch.from_numpy(rng.random(s) < 0.5) for n, s in shapes.items()}
    res = {}
    for dtype in (torch.float32, torch.float64):
        for where, on in ((torch.device("cpu"), "cpu"), (dev, "card")):
            res[(dtype, on)] = unet_grads(family, seed, where, dtype, x4, y4,
                                          masks)
    for dtype, gate in ((torch.float32, False), (torch.float64, True)):
        (lc, gc), (lg, gg) = res[(dtype, "cpu")], res[(dtype, "card")]
        loss_rel = abs(lg - lc) / abs(lc)
        gmax = max(float(np.abs(g).max()) for g in gc.values())
        worst, worst_key, zero = 0.0, "", 0.0
        for k, g in gc.items():
            a = gg[k]
            if ZERO_GRAD_UNET.search(k):
                zero = max(zero, max(np.abs(a).max(), np.abs(g).max()) / gmax)
                continue
            r = float(np.abs(a - g).max() / max(np.abs(g).max(), 1e-30))
            if r > worst:
                worst, worst_key = r, k
        bound = " (bounds 1e-3, 1e-5)" if gate else " (not gated, see above)"
        log(f"  card vs CPU, batch 4, {str(dtype)[6:]}: loss rel diff "
            f"{loss_rel:.3e} (bound 1e-5); worst leaf max|dg|/max|g| "
            f"{worst:.3e} at {worst_key}; exactly-zero leaves {zero:.1e} of "
            f"the largest gradient" + bound)
        require(loss_rel <= 1e-5, f"{family} {dtype}: loss rel {loss_rel}")
        if gate:
            require(worst <= 1e-3 and zero <= 1e-5,
                    f"{family} {dtype}: grad {worst} at {worst_key}, "
                    f"exactly-zero leaves {zero}")
    torch.cuda.empty_cache()


def phase_cli_train(dev, seed: int, tmp: str):
    """The train main paths: cli train as a user starts it, for each run
    of TRAIN_RUNS marked for it; counters zeroed before each, read after."""
    import numpy as np
    from ultrasound_modeling_tpu_torch import cli
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    from ultrasound_modeling_tpu_torch.utils.checkpoint import (
        Checkpointer, to_flax)

    log("phase 6: cli train --synthetic --epochs 1")
    total = {k: 0 for k in K2_KERNELS + K3_KERNELS + K5_KERNELS
             + K4_TRAIN_KERNELS}
    runs = [run[:4] for run in TRAIN_RUNS if run[4]]
    runs += [(family, "f32", "-", []) for family, _ in UNETS]
    ckpt_dir = os.path.join(tmp, "ckpt")
    trained = None
    for family, dtype, impl, flags in runs:
        name = f"{family}/{dtype}/{impl}"
        if name == CKPT_RUN:
            flags = [*flags, "--ckpt", ckpt_dir]
        argv = ["train", "--model", family, "--synthetic", "--epochs", "1",
                "--device", "cuda", "--seed", str(seed), "--log-dir",
                os.path.join(tmp, name.replace("/", "_")), *flags]
        K.reset_launch_counts()
        trainer = cli.main(argv)
        counts = dict(K.LAUNCHES)
        copies = dict(K.LAYOUT_COPIES)
        ep = trainer.last_epoch
        need = needed_kernels(family, impl)
        log(f"  {name:22s} launches { {k: counts[k] for k in total} } "
            f"layout copies {copies}")
        require(all(counts[k] > 0 for k in need),
                f"{name}: cli train did not launch {need}: {counts}")
        require(need or not any(counts.values()),
                f"{name}: a family with no kernel launched {counts}")
        steps = -(-max(64, 2 * TRAIN_BATCH[family]) // TRAIN_BATCH[family])
        require(ep["iters"] == steps and np.isfinite(ep["loss"]),
                f"{name}: epoch {ep}")
        _, init = seeded_model(family, seed, dtype, impl)
        now = to_flax(trainer.model.state_dict(), trainer.model.family)
        stats = [k for k in init if k.startswith("batch_stats/")]
        still = [k for k in init if np.array_equal(now[k], init[k])]
        # the BatchNorm running statistics moved (the ViT and the Swin
        # have none)
        require(not set(stats) & set(still),
                f"{name}: BatchNorm running statistics did not move: {still}")
        require(len(still) < len(init) // 2,
                f"{name}: {len(still)} of {len(init)} leaves did not move")
        bs = TRAIN_BATCH[family]
        log(f"  {name:22s} loss {ep['loss']:.4f}  {ep['frames_per_sec']:.1f} "
            f"frames/s  {1e3 * bs / ep['frames_per_sec']:.1f} ms/step "
            f"(epoch of {steps} steps, the first one's warm-up included); "
            f"{len(init) - len(still)} of {len(init)} leaves moved")
        for k in total:
            total[k] += counts[k]
        if name == CKPT_RUN:
            trained = {k: v.detach().cpu().clone()
                       for k, v in trainer.model.state_dict().items()}
            log(f"  {name:22s} --ckpt wrote steps {Checkpointer(ckpt_dir).steps()}")
        del trainer
    return total, ckpt_dir, trained


def phase_label2vec(dev, seed: int):
    """K6 as a caller uses it (it has no path in the system): the smoothed
    3-class targets of a train batch's labels, counters zeroed just before
    and read just after, against data/labels.label2vec plus the smoothing
    of train/losses.cce_smooth."""
    import numpy as np
    import torch
    from ultrasound_modeling_tpu_torch.data import synthetic
    from ultrasound_modeling_tpu_torch.data.labels import label2vec
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    log("phase 7: label2vec_smooth (K6), standalone")
    raw = synthetic.make_raw_array(TRAIN_BATCH["transunet"], seed + 3)
    y = torch.from_numpy(np.ascontiguousarray(raw[:, 0, :, :, 0])).to(dev)
    K.reset_launch_counts()
    got = K.label2vec_smooth(y, 0.1)
    torch.cuda.synchronize()
    counts = {k: K.LAUNCHES[k] for k in K6_KERNELS}
    want = label2vec(y) * 0.9 + 0.1 / 3
    err = (got - want).abs().max().item()
    log(f"  [{', '.join(map(str, y.shape))}] labels -> {tuple(got.shape)}, "
        f"max abs diff to label2vec + smoothing {err:.3e} (bound 1e-6); "
        f"launches {counts}")
    require(got.shape == (*y.shape, 3) and err <= 1e-6,
            f"K6: shape {tuple(got.shape)}, err {err}")
    require(counts["label2vec_smooth"] == 1, f"K6 launches {counts}")
    return counts


def launched(*names):
    """The counts of ``names`` since the counters were zeroed, and every
    other nonzero count."""
    from ultrasound_modeling_tpu_torch.ops import kernels as K
    return {k: v for k, v in K.LAUNCHES.items() if v or k in names}


def require_launched(counts, names, what):
    missing = [k for k in names if not counts.get(k)]
    require(not missing, f"{what}: kernels not launched {missing}: {counts}")


def gate(name, got, want, bf16):
    """PERF.md section 2's gates: f32 max abs probability diff <= 1e-4; bf16
    <= 0.05 and argmax agreement >= 0.99.  Returns (diff, agreement)."""
    diff = (got.float() - want.float()).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    bound = 0.05 if bf16 else 1e-4
    log(f"  {name}: max abs diff {diff:.3e} (bound {bound}), argmax "
        f"agreement {agree:.6f}" + (" (bound 0.99)" if bf16 else ""))
    require(torch_finite(got) and diff <= bound
            and (not bf16 or agree >= 0.99), f"{name}: diff {diff}, "
                                              f"agreement {agree}")
    return diff, agree


def torch_finite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def frames_per_s(fn, x, reps: int = 5) -> float:
    import torch
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    torch.cuda.synchronize()
    return reps * x.shape[0] / (time.perf_counter() - t0)


def phase_restore_eval(dev, seed: int, tmp: str, ckpt_dir: str, trained):
    """8a: phase 6's checkpoint restored into a fresh model (every tensor
    bit-equal to the trained model's), then ``cli eval --ckpt`` as a user
    starts it (the f32 eval forward: K4)."""
    import math
    import torch
    from ultrasound_modeling_tpu_torch import cli
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    log(f"phase 8a: restore the {CKPT_RUN} checkpoint, cli eval --ckpt")
    cfg = default_config("transunet")
    model = cli._restore_model(cfg.model, cfg.train, ckpt_dir, dev)
    got = model.state_dict()
    require(set(got) == set(trained), "restored keys differ")
    bad = [k for k, v in trained.items() if not torch.equal(got[k].cpu(), v)]
    require(not bad, f"restored tensors differ: {bad[:5]}")
    log(f"  {len(trained)} tensors restored bit-equal")
    del model, got
    K.reset_launch_counts()
    summary = cli.main(["eval", "--synthetic", "--ckpt", ckpt_dir, "--device",
                        "cuda", "--seed", str(seed), "--log-dir",
                        os.path.join(tmp, "eval")])
    counts = launched(*K4_KERNELS)
    require(summary and all(math.isfinite(v) for v in summary.values()),
            f"eval summary {summary}")
    require_launched(counts, K4_KERNELS, "cli eval")
    log(f"  cli eval: f1 {summary['f1']:.5f}, loss {summary['loss']:.5f}; "
        f"launches {counts}")
    return counts


def phase_cascade(dev, seed: int, x):
    """8b: the brain -> bleed cascade (``infer/evaluate.make_cascade``) at
    batch 64: a 2-class brain TransUNet in f32 (K4) and a 3-class bleed
    TransUNet in bf16 (K1), seeded weights; the kernel route against the
    plain route.  Frames whose two masks differ anywhere have different
    bleed inputs, so the bleed gates hold over the others."""
    import torch
    from ultrasound_modeling_tpu_torch.infer import evaluate as ev
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    log(f"phase 8b: cascade, brain f32 (2 classes) -> bleed bf16, batch "
        f"{x.shape[0]}")
    brain = seeded_model("transunet", seed + 20, num_classes=2)[0].eval().to(dev)
    bleed = seeded_model("transunet", seed + 21, "bf16")[0].eval().to(dev)
    cascade = ev.make_cascade(brain, bleed, return_mask=True)
    out = {}
    with torch.inference_mode():
        for route in ("kernel", "plain"):
            with K.plain_versions(route == "plain"):
                K.reset_launch_counts()
                probs, mask = cascade(x)
                torch.cuda.synchronize()
                counts = launched(*K1_KERNELS, *K4_KERNELS)
                out[route] = (brain(x), probs, mask, counts)
            if route == "kernel":
                require_launched(counts, K1_KERNELS + K4_KERNELS
                                 + EVAL_NORM_KERNELS, "cascade")
                rate = frames_per_s(cascade, x)
            else:
                require(not any(counts.values()), f"plain route {counts}")
    (bk, pk, mk, counts), (bp, pp, mp, _) = out["kernel"], out["plain"]
    gate("brain probabilities, kernel vs plain", bk, bp, False)
    agree = (mk == mp).float().mean().item()
    same = (mk == mp).flatten(1).all(1)
    log(f"  mask agreement {agree:.7f} (bound 0.999); brain kept "
        f"{mk.mean().item():.4f} of the pixels; {int(same.sum())} of "
        f"{len(same)} frames with equal masks")
    require(agree >= 0.999 and same.any(), f"mask agreement {agree}")
    gate("bleed probabilities over those frames", pk[same], pp[same], True)
    log(f"  cascade {rate:.1f} frames/s (kernel route); launches {counts}")
    del brain, bleed
    torch.cuda.empty_cache()
    return counts


def phase_int8(dev, model, x):
    """8c: int8 weight-only serving (``infer/quantize.QuantizedForward``) at
    batch 64, f32 and bf16: the kernel route against the plain route on the
    same int8 weights; the resident weight MiB, the argmax agreement with
    the unquantized forward, frames/s.  Returns the launches and the int8
    forward (its model, ``model``, moved to the card)."""
    import torch
    from ultrasound_modeling_tpu_torch.infer.quantize import QuantizedForward
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    log(f"phase 8c: int8 weight-only forward, batch {x.shape[0]}")
    total = {}
    host = model.to("cpu")
    qf = QuantizedForward(host, dev)
    f32_mib = sum(t.numel() * t.element_size()
                  for t in host.state_dict().values()) / 2 ** 20
    log(f"  resident weights: int8 {qf.resident_bytes() / 2 ** 20:.1f} MiB "
        f"against f32 {f32_mib:.1f} MiB; {qf.fraction:.4f} of the parameter "
        f"scalars int8")
    full = host.to(dev)      # the unquantized forward, for the agreement
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        full.compute_dtype = dt
        out = {}
        with torch.inference_mode():
            for route in ("kernel", "plain"):
                K.reset_launch_counts()
                with K.plain_versions(route == "plain"):
                    out[route] = qf(x)
                torch.cuda.synchronize()
                counts = launched()
                if route == "kernel":
                    need = (K1_KERNELS if name == "bf16" else K4_KERNELS
                            ) + EVAL_NORM_KERNELS
                    require_launched(counts, need, f"int8 {name}")
                    for k, v in counts.items():
                        total[k] = total.get(k, 0) + v
                    kernel_counts = counts
                    rate = frames_per_s(qf, x)
                    ref = full(x)
                else:
                    require(not any(counts.values()), f"plain route {counts}")
        gate(f"int8 {name}, kernel vs plain", out["kernel"], out["plain"],
             name == "bf16")
        agree = (out["kernel"].argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"  int8 {name}: argmax agreement with the unquantized forward "
            f"{agree:.6f}; max abs diff {(out['kernel'] - ref).abs().max().item():.3e}; "
            f"{rate:.1f} frames/s; launches {kernel_counts}")
    full.compute_dtype = torch.float32
    torch.cuda.empty_cache()
    return total, qf


# (compute dtype, batch (None: symbolic), quantize): phase 8d's artifacts,
# symbolic and static batch, f32 and int8, K4 (f32) and K1 (bf16) each
EXPORTS = (("f32", None, None), ("f32", BATCH, "int8"), ("bf16", BATCH, None),
           ("bf16", None, "int8"))


def phase_export(dev, model, qf, x, tmp: str):
    """8d: ``infer/export.py`` artifacts of the full-width TransUNet, saved,
    loaded and run at b1 and b64 (static: b64) against the eager forward;
    the counters zeroed before each loaded artifact's call and read after:
    K4 (f32) or K1 (bf16) launched from the artifact.  ``qf`` is the int8
    forward of ``model`` (phase 8c's), the int8 artifacts' eager
    reference."""
    import torch
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.infer import export as ex
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    log("phase 8d: torch.export artifacts, saved, loaded and run")
    total = {}
    mcfg = default_config("transunet").model
    for dtype, batch, q in EXPORTS:
        bf16 = dtype == "bf16"
        model.compute_dtype = torch.bfloat16 if bf16 else torch.float32
        t0 = time.perf_counter()
        exported = ex.export_forward(mcfg, model, x.shape[1:], batch=batch,
                                     quantize=q)
        path = os.path.join(tmp, "artifact.pt2")
        ex.save_exported(exported, path)
        fn, shape, pinned = ex.load_exported_meta(path, dev)
        secs = time.perf_counter() - t0
        require(shape == tuple(x.shape[1:]) and pinned == batch,
                f"artifact meta {shape} {pinned}")
        eager = qf if q else model
        name = f"{dtype}{' int8' if q else ''} batch {batch or 'symbolic'}"
        log(f"  {name}: exported, saved and loaded in {secs:.1f} s, "
            f"{os.path.getsize(path) / 2 ** 20:.1f} MiB")
        for b in ((1, x.shape[0]) if batch is None else (batch,)):
            with torch.inference_mode():
                K.reset_launch_counts()
                got = fn(x[:b])
                torch.cuda.synchronize()
                counts = launched()
                want = eager(x[:b])
            require_launched(counts, (K1_KERNELS if bf16 else K4_KERNELS)
                             + EVAL_NORM_KERNELS, f"artifact {name}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            diff = (got - want).abs().max().item()
            # the artifact launches the eager forward's kernels on the same
            # inputs: a bf16 one matches it to rounding noise, which a
            # dropped or stale step would exceed
            bound = 1e-6 if bf16 else 1e-5
            rates = ""
            if b == x.shape[0]:
                with torch.inference_mode():
                    rates = (f"; {frames_per_s(fn, x):.1f} frames/s, the eager "
                             f"forward {frames_per_s(eager, x):.1f}")
            log(f"    b{b}: max abs diff to the eager forward {diff:.3e} "
                f"(bound {bound}); launches from the artifact {counts}{rates}")
            require(torch_finite(got) and got.shape == (b, *x.shape[1:3], 3)
                    and diff <= bound, f"artifact {name} b{b}: diff {diff}")
        os.remove(path)
        del exported, fn, eager
    model.compute_dtype = torch.float32
    torch.cuda.empty_cache()
    return total


def phase_serve_int8(dev, ckpt_dir: str, x):
    """8e: ``cli serve --ckpt D --quantize int8`` as a user starts it,
    answering two requests (1 and 3 frames) against the int8 forward of the
    same checkpoint; the counters zeroed before the server starts and read
    after it stops."""
    import socket
    import numpy as np
    import torch
    from ultrasound_modeling_tpu_torch import cli
    from ultrasound_modeling_tpu_torch.config import default_config
    from ultrasound_modeling_tpu_torch.infer.server import InferenceServer
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    log(f"phase 8e: cli serve --ckpt (the {CKPT_RUN} run) --quantize int8")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    servers, errors, results = [], [], {}
    serve_forever = InferenceServer.serve_forever

    def recorded(self):
        servers.append(self)
        serve_forever(self)

    def run():
        try:
            cli.main(["serve", "--ckpt", ckpt_dir, "--quantize", "int8",
                      "--device", "cuda", "--port", str(port)])
        except BaseException as e:  # surfaced by the checks below
            errors.append(repr(e))

    InferenceServer.serve_forever = recorded
    K.reset_launch_counts()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{port}"
    frames = x[:4].cpu().numpy()
    try:
        deadline = time.time() + 300
        while not servers and not errors and time.time() < deadline:
            time.sleep(0.2)
        require(servers and not errors, f"serve did not start: {errors}")

        def post(key, batch):
            try:
                buf = io.BytesIO()
                np.save(buf, batch)
                req = urllib.request.Request(
                    f"{url}/predict", data=buf.getvalue(),
                    headers={"Content-Type": "application/octet-stream"})
                results[key] = np.load(io.BytesIO(
                    urllib.request.urlopen(req, timeout=300).read()))
            except Exception as e:  # surfaced by the check below
                errors.append(f"{key}: {e!r}")

        posts = [threading.Thread(target=post, args=a)
                 for a in (("one", frames[:1]), ("three", frames[1:4]))]
        for t in posts:
            t.start()
        for t in posts:
            t.join()
    finally:
        InferenceServer.serve_forever = serve_forever
        for server in servers:
            server.shutdown()
        th.join(60)
    require(not errors and not th.is_alive(), f"serve: {errors}")
    counts = launched(*K4_KERNELS)
    require_launched(counts, K4_KERNELS, "serve --quantize int8")
    cfg = default_config("transunet")
    want = cli._make_forward(cfg.model, cfg.train, ckpt_dir, dev, "int8")(
        x[:4]).cpu().numpy()
    got = np.concatenate([results["one"], results["three"]])
    diff = float(np.abs(got - want).max())
    log(f"  2 requests / 4 frames answered; max abs diff to the int8 forward "
        f"{diff:.3e} (bound 1e-4); launches {counts}")
    require(np.isfinite(got).all() and diff <= 1e-4, f"served diff {diff}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and inputs")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, PKG, "csrc")):
        print(f"chip_smoke.py: {PKG}/ not found beside this script; run it "
              f"from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device visible to torch; this check "
              "runs only on the card", file=sys.stderr)
        return 1
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    from ultrasound_modeling_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log("phase 1: card and build")
    print(card, flush=True)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    full_f32_matmuls()
    t0 = time.perf_counter()
    K.build()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s "
        f"({K.BUILD_DIR.name}/)")
    ptxas = [ln.strip() for ln in K.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    for ln in ptxas:
        log(f"  ptxas: {ln}")
    checks = Checks()
    # launches per kernel summed over the main paths, each path driven with
    # the counters zeroed just before it and read just after
    counts = {}

    def add(path_counts):
        for k, v in path_counts.items():
            counts[k] = counts.get(k, 0) + v

    try:
        k2_report(K)
        phase_tensor_cores(K)
        phase_kernels(checks, dev, args.seed)
        retime_r4_r9(dev, args.seed)
        phase_train_kernels(checks, dev, args.seed)
        phase_vit_kernels(checks, dev, args.seed)
        phase_gemm(checks, dev, args.seed)
        with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_") as tmp:
            for family, phase in (("transunet", "3"), ("vit", "3b"),
                                  ("swin", "3c")):
                x, ref, flat = phase_forward(dev, args.seed, BATCH, family, phase)
                add(phase_serve(dev, x, ref, flat, tmp, family,
                                phase.replace("3", "4")))
                del x, ref, flat
            for family, letter in UNETS:
                x, ref, flat = phase_unet_forward(dev, args.seed, BATCH,
                                                  family, "3" + letter)
                add(phase_serve(dev, x, ref, flat, tmp, family, "4" + letter))
                del x, ref, flat
            phase_train_step(dev, args.seed)
            for family, letter in UNETS:
                phase_unet_train(dev, args.seed, family, "5b" + letter)
            totals, ckpt_dir, trained = phase_cli_train(dev, args.seed, tmp)
            add(totals)
            add(phase_label2vec(dev, args.seed))
            add(phase_restore_eval(dev, args.seed, tmp, ckpt_dir, trained))
            x = torch.from_numpy(np.random.default_rng(args.seed + 30)
                                 .standard_normal((BATCH, 256, 80, 10))
                                 .astype(np.float32)).to(dev)
            add(phase_cascade(dev, args.seed, x))
            model = seeded_model("transunet", args.seed)[0].eval()
            counts8c, qf = phase_int8(dev, model, x)
            add(counts8c)
            add(phase_export(dev, model, qf, x, tmp))
            del model, qf
            add(phase_serve_int8(dev, ckpt_dir, x))
        require(not any(m.split(".")[0] in ("jax", "flax") for m in sys.modules),
                "jax or flax was imported")
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAIL: {e}", file=sys.stderr)
        return 1

    where = {"transformer_block": (K1_SRC, K1_TPU),
             "window_attention": (K4_SRC, K4_TPU),
             "tb_layer_norm": (K1_SRC, K1_TPU), "tb_linear": (K1_SRC, K1_TPU),
             "tb_attention_core": (K1_SRC, K1_TPU),
             "wa_linear": (K4_SRC, K4_TPU), "wa_attention_core": (K4_SRC, K4_TPU),
             "wa_window_fwd": (K4_SRC, K4_TPU), "wa_linear_narrow": (GEMM_SRC, K4_TPU),
             "wa_attention_bwd": (K4B_SRC, K4B_TPU),
             "wa_wgrad": (K4W_SRC, K4B_TPU),
             "group_flat_norm_fwd": (K2_SRC, K2_FWD_TPU),
             "group_flat_norm_bwd": (K2_SRC, K2_BWD_TPU),
             "flash_attention_fwd": (K3_SRC, K3_FWD_TPU),
             "flash_attention_bwd": (K3_SRC, K3_BWD_TPU),
             "attention_train": (K5_SRC, K5_TPU),
             "at_attention_core": (K5_SRC, K5_TPU),
             "label2vec_smooth": (K6_SRC, K6_TPU)}
    idle = [name for name in where if not counts.get(name)]
    if idle:
        print(f"chip_smoke.py: FAIL: launched no time on their main paths: "
              f"{idle}", file=sys.stderr)
        return 1
    kernels = []
    for name, (src, tpu) in where.items():
        r = checks.results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": tpu, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

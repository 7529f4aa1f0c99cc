"""Where the device time goes: ``torch.profiler`` over the port's serving
forward and train step, one line per cell, on the card.

    python -m ultrasound_modeling_tpu_torch.profiling [FAMILY | FAMILY:CELL ...]

(the cells of the families named and the cells named, or all of them).  A cell is a family
and ``serve-{f32,bf16}`` (the kernel path's forward at batch 64) or
``train-{f32,bf16}[-{composed,flash,pallas,k4}]`` (the whole train step as
the family's Trainer builds it (its loss and optimizer rule), kernel
route, augmentation on, at the family's batch: ViT 8, TransUNet 32, Swin
32, ResNeStUNet 64, MobileUNet 256); a trailing ``-plain`` runs the step
under ``ops.kernels.plain_versions()``, every kernel's plain version.
The ViT runs every cell, the TransUNet both serving cells and its f32
composed and bf16 flash train steps, the Swin both serving cells and its
f32 and bf16 train steps (``k4``: it trains on K4 and its backward, drop
path on), the f32 one also on the plain route, the ResNeStUNet and the
MobileUNet (no kernel on their paths; dropout on in train) both serving
cells and both train steps, at the family's frame shape; the TransUNet's
``serve-bf16-exported[-static]`` cells serve its bf16 forward from a
loaded ``torch.export`` artifact (symbolic batch, or pinned at 64).  Each cell runs
3 warm-ups, then 5 unprofiled repetitions (host clock around
``synchronize``: the wall ms; the least host time one of them took to
return, its enqueue where the queue does not fill: host min ms), then 3
profiled ones.  Device ms is the
kernels' summed time per repetition; idle = 1 - device / unprofiled wall;
peak MiB is ``torch.cuda.max_memory_allocated`` over the cell.  The columns split the device time into the
attention forward kernel (``attention_fwd_kernel``: K1's, K4's at N > 32
and K5's cores and K3's forward), K4's per-window forward core
(``wa_window_fwd_kernel``, N <= 32: the Swin's), K3's backward passes
(``fa_bwd_*``), the port's GEMMs on the 128 x 128 schedule
(``linear_wgmma_kernel``: ``tb_linear`` / ``wa_linear``) and on the
narrow one (``linear_narrow_kernel``: ``wa_linear`` at the Swin's
widths), K2 (``gfn_*``: forward, backward and its column reduce), the
attention kernel of K4's backward (``wa_bwd_*``, with its d_addmask
reduce: ``k4_bwd_core_ms``) and its weight and bias gradients
(``wa_wgrad_*``, with its reduce of the row runs: ``k4_bwd_wgrad_ms``),
give the device time of K4's whole backward (the kernels under
autograd's ``WindowAttentionFusedBackward`` node: ``k4_bwd_ms``) and of
the GEMMs in it (``k4_bwd_gemm_ms``: its three ``wa_linear`` calls), and
list the three largest kernels.  Weights are random from seed 0, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ultrasound_modeling_tpu_torch.config import default_config
from ultrasound_modeling_tpu_torch.device import resolve_device

SEED, SERVE_BATCH = 0, 64
CELLS = (("vit", "serve-f32"), ("vit", "serve-bf16"),
         ("vit", "train-f32-composed"), ("vit", "train-f32-flash"),
         ("vit", "train-f32-pallas"), ("vit", "train-bf16-flash"),
         ("vit", "train-bf16-pallas"),
         ("transunet", "serve-f32"), ("transunet", "serve-bf16"),
         ("transunet", "serve-bf16-exported"),
         ("transunet", "serve-bf16-exported-static"),
         ("transunet", "train-f32-composed"), ("transunet", "train-bf16-flash"),
         ("swin", "serve-f32"), ("swin", "serve-bf16"), ("swin", "train-f32-k4"),
         ("swin", "train-f32-k4-plain"), ("swin", "train-bf16-k4"),
         ("resnest_unet", "serve-f32"), ("resnest_unet", "serve-bf16"),
         ("resnest_unet", "train-f32"), ("resnest_unet", "train-bf16"),
         ("mobileunet", "serve-f32"), ("mobileunet", "serve-bf16"),
         ("mobileunet", "train-f32"), ("mobileunet", "train-bf16"))
GROUPS = {"attention_fwd": ("attention_fwd_kernel",),
          "k3_bwd": ("fa_bwd_query_kernel", "fa_bwd_key_kernel"),
          "port_gemm": ("linear_wgmma_kernel",),
          "k2": ("gfn_forward_kernel", "gfn_backward_kernel",
                 "gfn_reduce_kernel"),
          "k4_bwd_core": ("wa_bwd_kernel", "wa_bwd_reduce_kernel"),
          "k4_bwd_wgrad": ("wa_wgrad_kernel", "wa_wgrad_reduce_kernel"),
          "k4_window_core": ("wa_window_fwd_kernel",),
          "narrow_gemm": ("linear_narrow_kernel",)}
# the GEMM kernels (both schedules) whose time inside K4's backward is
# summed apart
K4_BWD_GEMMS = ("linear_wgmma_kernel", "linear_narrow_kernel")


def _model(family: str, dtype: str, attn_train: str, device):
    from ultrasound_modeling_tpu_torch.models.registry import build_model
    from ultrasound_modeling_tpu_torch.utils.checkpoint import (
        from_flax, random_flax_variables)
    mcfg = dataclasses.replace(
        default_config(family).model, attn_train_impl=attn_train,
        compute_dtype="bfloat16" if dtype == "bf16" else "float32")
    model = build_model(mcfg)
    model.load_state_dict(from_flax(random_flax_variables(model, SEED),
                                    model.family), strict=True)
    return model.to(device)


def _loaded_artifact(mcfg, model, frame, batch, device):
    """``model``'s forward exported (``infer/export.py``), saved and loaded
    back, as ``serve --exported`` runs it."""
    import os
    import tempfile
    from ultrasound_modeling_tpu_torch.infer import export as ex
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "artifact.pt2")
        ex.save_exported(ex.export_forward(mcfg, model, frame, batch=batch),
                         path)
        return ex.load_exported(path, device)


def _cell_fn(family: str, cell: str, device):
    """(one repetition of the cell, frames a repetition)."""
    from ultrasound_modeling_tpu_torch.data import synthetic
    from ultrasound_modeling_tpu_torch.ops import kernels
    from ultrasound_modeling_tpu_torch.train.loop import loss_for, optimizer_for
    from ultrasound_modeling_tpu_torch.train.step import (
        TrainState, make_train_step)
    cfg = default_config(family)
    frame = (*cfg.model.img_size, cfg.model.in_channels)
    parts = cell.split("-")
    if parts[0] == "serve":
        model = _model(family, parts[1], "xla", device).eval()
        x = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(
            (SERVE_BATCH, *frame)).astype(np.float32)).to(device)
        fwd = model
        if parts[2:3] == ["exported"]:
            fwd = _loaded_artifact(cfg.model, model, frame, SERVE_BATCH
                                   if parts[3:] == ["static"] else None, device)

        def serve():
            with torch.inference_mode():
                fwd(x)
        return serve, SERVE_BATCH
    dtype = parts[1]
    impl = {"composed": "xla"}.get(parts[2], parts[2]) if parts[2:] else "xla"
    model = _model(family, dtype, impl, device).train()
    bs = cfg.train.batch_size
    raw = synthetic.make_raw_array(bs, SEED + 2, *frame)
    x = torch.from_numpy(np.ascontiguousarray(raw[:, 0, :, :, 1:-1])).to(device)
    y = torch.from_numpy(np.ascontiguousarray(raw[:, 0, :, :, 0])).to(device)
    state = TrainState(model, optimizer_for(family, cfg.train)(model), 0,
                       torch.Generator(device=device).manual_seed(SEED),
                       torch.Generator(device=device).manual_seed(SEED + 1))
    step = make_train_step(model, loss_for(cfg.train),
                           l2_scale=cfg.train.l2_regularization)

    def train():
        with kernels.plain_versions(parts[3:] == ["plain"]):
            step(state, x, y, 1e-4)
    return train, bs


def _kernels_under(ev):
    """(name, device us) of every kernel launched under the profiler's CPU
    event ``ev``, its child ops' included (kernels launched through the
    port's C entry points are attached to the innermost op, here the
    autograd node)."""
    for k in ev.kernels:
        yield k.name, k.duration
    for child in ev.cpu_children:
        yield from _kernels_under(child)


def profile_cell(family: str, cell: str, device) -> dict:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    fn, frames = _cell_fn(family, cell, device)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue = []
    for _ in range(5):
        t1 = time.perf_counter()
        fn()
        enqueue.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    reps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    launches = 0
    k4_bwd_us = k4_bwd_gemm_us = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.device_time_total if hasattr(ev, "device_time_total") \
                else ev.cuda_time_total
            kernels[ev.name] = kernels.get(ev.name, 0.0) + us / 1e3 / reps
            launches += 1
        elif ev.name == "WindowAttentionFusedBackward":
            k4_bwd_us += ev.device_time_total
            k4_bwd_gemm_us += sum(us for name, us in _kernels_under(ev)
                                  if any(k in name for k in K4_BWD_GEMMS))
    device_ms = sum(kernels.values())
    groups = {g: sum(ms for n, ms in kernels.items() if any(k in n for k in keys))
              for g, keys in GROUPS.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
    return {"family": family, "cell": cell, "wall_ms": wall,
            "host_min_ms": min(enqueue) * 1e3,
            "frames_per_s": 1e3 * frames / wall, "device_ms": device_ms,
            "idle": 1.0 - device_ms / wall, "launches": launches / reps,
            **{f"{g}_ms": ms for g, ms in groups.items()},
            "k4_bwd_ms": k4_bwd_us / 1e3 / reps,
            "k4_bwd_gemm_ms": k4_bwd_gemm_us / 1e3 / reps,
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "top": [(n[:60], ms) for n, ms in top]}


def main():
    device = resolve_device("cuda")
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    full_f32_matmuls()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"{torch.cuda.get_device_name(0)}, power limit "
          f"not read (nvidia-smi: rc {smi.returncode} {smi.stderr.strip()})",
          flush=True)
    wanted = set(sys.argv[1:])
    for family, cell in CELLS:
        if wanted and not wanted & {family, f"{family}:{cell}"}:
            continue
        row = profile_cell(family, cell, device)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""Command-line interface of the PyTorch port: ``train``, ``eval``,
``infer``, ``export`` and ``serve``, as in the JAX package's cli (whose
``etl`` and ``bench`` are not ported yet).  Every subcommand runs on the
card (``--device cuda``, the default) and refuses to start without one;
``--device cpu`` runs it on the CPU.

    python -m ultrasound_modeling_tpu_torch.cli train --synthetic \
        [--model {transunet,vit,swin,resnest_unet,mobileunet}] [--epochs N] \
        [--batch-size B] [--bf16] [--attn-train {xla,flash,pallas}] \
        [--seed S] [--config C.toml] [--ckpt DIR [--resume]]
    python -m ultrasound_modeling_tpu_torch.cli eval --synthetic --ckpt DIR
    python -m ultrasound_modeling_tpu_torch.cli infer --ckpt DIR \
        [--archive ARCHIVE_DIR] [--cascade BRAIN_CKPT] [--cardiac] \
        [--quantize int8] [--exported FILE] --out OUT
    python -m ultrasound_modeling_tpu_torch.cli export --ckpt DIR \
        [--batch B] [--quantize int8] --out FILE.pt2
    python -m ultrasound_modeling_tpu_torch.cli serve \
        {--ckpt DIR [--quantize int8] | --exported FILE | --params P.npz}

``train --ckpt DIR`` saves the run's state (``utils.checkpoint.
Checkpointer``: one ``ckpt_{step}.pt`` per save, the newest three kept) after
every epoch that crosses ``checkpoint_every_steps`` and at the end;
``--resume`` takes the run up from the latest.  ``eval``, ``infer``,
``export`` and ``serve --ckpt`` restore its model part through one path
(:func:`_restore_model`, :func:`_make_forward`).  ``infer`` renders
panels with matplotlib.

``serve --params`` takes weights from the JAX side as a flax-layout npz
(``utils/checkpoint``)::

    # JAX side, from a restored TrainState `state`
    from ultrasound_modeling_tpu.utils.checkpoint import save_params_npz
    save_params_npz({"params": state.params,
                     "batch_stats": state.batch_stats}, "P.npz")

The server is ``infer/server.py``, the port's copy of the JAX package's
(stdlib + numpy), over this port's forward; ``/predict`` takes float32 NHWC
frames of the family's shape (``[B, 256, 80, 10]``; the ResNeStUNet's
``[B, 256, 64, 6]``, the MobileUNet's ``[B, 256, 64, 15]``) and answers
float32 probabilities ``[B, H, W, 3]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ultrasound_modeling_tpu_torch.config import default_config, from_toml
from ultrasound_modeling_tpu_torch.device import resolve_device
from ultrasound_modeling_tpu_torch.utils.tracing import span

# the model families this port builds: all five
PORTED = ("transunet", "vit", "swin", "resnest_unet", "mobileunet")


def build_config(args):
    """The ``--config`` TOML or the family's default config, with the
    command line's overrides."""
    cfg = from_toml(args.config) if args.config else default_config(args.model)
    model, train = cfg.model, cfg.train
    if args.num_classes is not None:
        model = dataclasses.replace(model, num_classes=args.num_classes)
    if args.bf16:
        model = dataclasses.replace(model, compute_dtype="bfloat16")
    if args.attn_train:
        model = dataclasses.replace(model, attn_train_impl=args.attn_train)
    if args.batch_size:
        train = dataclasses.replace(train, batch_size=args.batch_size)
    if args.seed is not None:
        train = dataclasses.replace(train, seed=args.seed)
    if getattr(args, "epochs", None):
        train = dataclasses.replace(train, epochs=args.epochs)
    return cfg.replace(model=model, train=train)


def build_dataset(cfg, args, device: torch.device):
    from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
    if args.synthetic or not args.train_data:
        h, w = cfg.model.img_size
        bs = cfg.train.batch_size
        return Dataset.synthetic(
            n_train=max(64, 2 * bs), n_test=max(16, bs), height=h, width=w,
            n_disp=cfg.model.in_channels, num_classes=cfg.model.num_classes,
            device=device)
    return Dataset.from_npy(args.train_data, args.val_data,
                            cfg.model.num_classes, device=device)


def _restore_model(mcfg, tcfg, ckpt_dir: Optional[str], device: torch.device,
                   params: Optional[str] = None) -> torch.nn.Module:
    """The family's model in eval mode on ``device``, with the model part of
    the newest checkpoint in ``ckpt_dir``, or the flax-layout npz
    ``params``, or else the seeded initial weights ``cli train`` starts
    from (``tcfg.seed``).  ``infer``, ``export`` and ``serve`` all restore
    through it, so the restore cannot drift between them."""
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    from ultrasound_modeling_tpu_torch.models.registry import build_model
    from ultrasound_modeling_tpu_torch.utils import checkpoint as ck

    full_f32_matmuls()
    model = build_model(mcfg)
    if params:
        sd = ck.load_params_npz(params, model.family)
    elif ckpt_dir:
        sd = ck.Checkpointer(ckpt_dir).restore(model.state_dict(),
                                               section="model")
    else:
        sd = ck.from_flax(ck.random_flax_variables(model, tcfg.seed),
                          model.family)
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()


def _make_forward(mcfg, tcfg, ckpt_dir: Optional[str], device: torch.device,
                  quantize: Optional[str] = None,
                  params: Optional[str] = None) -> Callable:
    """A restored ``x -> probs`` on ``device`` (tensors in and out), the
    port's counterpart of the reference's per-process
    ``keras.models.load_model`` (reference: TBIEvaluator.py:221-236).
    ``quantize='int8'`` keeps only int8 kernels (and the small leaves) on
    the device and dequantizes them there in every call
    (``infer/quantize.py``); the f32 model then stays on the host."""
    if quantize:
        if quantize != "int8":
            raise ValueError(f"unknown quantize mode {quantize!r}")
        from ultrasound_modeling_tpu_torch.infer.quantize import (
            make_quantized_forward)
        model = _restore_model(mcfg, tcfg, ckpt_dir, torch.device("cpu"),
                               params)
        return make_quantized_forward(model, device)
    model = _restore_model(mcfg, tcfg, ckpt_dir, device, params)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return model(x).float()

    return forward


def build_serving_model(params_path: str, bf16: bool, device: torch.device,
                        model_name: str = "transunet") -> torch.nn.Module:
    """The family's default-config model with weights from a flax-layout
    npz."""
    mcfg = default_config(model_name).model
    if bf16:
        mcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16")
    return _restore_model(mcfg, None, None, device, params=params_path)


# bytes of frames in each chunk of a staged copy to the card: the host's copy
# of one chunk into pinned memory runs while the card reads the chunk before.
# On the H100's host a b64 batch (52.4 MB) crossed fastest in 16 MiB chunks,
# both to the host's return and to the end of the DMA (1-64 MiB tried,
# tests/test_torch_staging.py::test_copy_rates_on_the_card_host)
STAGE_CHUNK_BYTES = 16 << 20

# calls of make_forward's closures through pinned staging (``staged``) and on
# the CPU path (``plain``), and page-locked allocations of a staging buffer
# (``grown``)
STAGING = {"staged": 0, "grown": 0, "plain": 0}


def reset_staging_counts() -> None:
    for k in STAGING:
        STAGING[k] = 0


def chunk_rows(rows: int, row_bytes: int) -> List[Tuple[int, int]]:
    """``(start, stop)`` ranges that split ``rows`` rows of ``row_bytes``
    each into chunks of at most :data:`STAGE_CHUNK_BYTES` (a row larger than
    that is a chunk of its own), in order."""
    step = max(1, STAGE_CHUNK_BYTES // max(1, row_bytes))
    return [(a, min(a + step, rows)) for a in range(0, rows, step)]


class _Staging:
    """The page-locked float32 buffer one CUDA closure of
    :func:`make_forward` copies its frames through, sized to the largest
    batch seen and reused; a smaller batch takes its front.  ``done`` marks
    the end of the last copy out of it, which the next call waits for
    before it writes; ``lock`` keeps two threads' calls from interleaving."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buf: Optional[torch.Tensor] = None
        self.done = torch.cuda.Event()
        self.lock = threading.Lock()

    def to_device(self, x: np.ndarray) -> torch.Tensor:
        """``x`` on the card, copied chunk by chunk: the host copies a chunk
        into the buffer, then queues its DMA on the current stream and goes
        on to the next, so that the forward's kernels queue behind the
        last one."""
        src = torch.from_numpy(x)
        xt = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        n = src.numel()
        row_bytes = src.element_size() * math.prod(src.shape[1:])
        with self.lock:
            self.done.synchronize()
            if self.buf is None or self.buf.numel() < n:
                self.buf = torch.empty(n, dtype=torch.float32, pin_memory=True)
                STAGING["grown"] += 1
            stage = self.buf[:n].view(src.shape)
            stream = torch.cuda.current_stream(self.device)
            try:
                for a, b in chunk_rows(len(src), row_bytes):
                    stage[a:b].copy_(src[a:b])
                    xt[a:b].copy_(stage[a:b], non_blocking=True)
            finally:
                self.done.record(stream)
            STAGING["staged"] += 1
        return xt

    def to_host(self, probs: torch.Tensor) -> np.ndarray:
        """``probs`` in a page-locked tensor of its own (torch's caching host
        allocator reuses the blocks of answers the callers have dropped), as
        numpy: the caller owns every answer."""
        out = torch.empty_like(probs, device="cpu", pin_memory=True)
        out.copy_(probs, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return out.numpy()


def make_forward(model: Callable, device: torch.device
                 ) -> Callable[[np.ndarray], np.ndarray]:
    """``x [B, H, W, C]`` float32 numpy -> float32 numpy probabilities,
    through ``model`` (a module or any ``x -> probs`` on tensors) on
    ``device``.  Under a profiler each call is the span ``serve.batch``
    (``utils.tracing``) of three: ``serve.h2d`` (the frames to the device),
    ``serve.forward`` (the forward enqueued) and ``serve.d2h`` (the wait
    for it and the copy back).

    On a CUDA device the frames cross through a page-locked buffer the
    closure keeps (:class:`_Staging`), in chunks of
    :data:`STAGE_CHUNK_BYTES` whose host copies overlap their DMA, and the
    answer comes back into page-locked memory; on the CPU the frames are
    wrapped and copied as they are.  :data:`STAGING` counts both."""
    staging = _Staging(device) if device.type == "cuda" else None

    def forward(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode(), span("serve.batch"):
            with span("serve.h2d"):
                x = np.ascontiguousarray(x, np.float32)
                if staging is None:
                    STAGING["plain"] += 1
                    xt = torch.from_numpy(x).to(device)
                else:
                    xt = staging.to_device(x)
            with span("serve.forward"):
                probs = model(xt).float()
            with span("serve.d2h"):
                if staging is None:
                    return probs.cpu().numpy()
                return staging.to_host(probs)
    return forward


def _refuse_quantize_exported(args) -> None:
    if args.quantize:
        raise SystemExit("--quantize does nothing for --exported artifacts; "
                         "quantize at export time: `export --quantize int8`")


def cmd_serve(args) -> None:
    """Serve over HTTP with dynamic micro-batching from a checkpoint
    (``--ckpt``, optionally ``--quantize int8``), an exported artifact
    (``--exported``) or a flax-layout npz (``--params``)."""
    from ultrasound_modeling_tpu_torch.infer.server import InferenceServer

    sources = [s for s in (args.ckpt, args.exported, args.params) if s]
    if len(sources) != 1:
        raise SystemExit(
            "serve needs trained weights from one source: --ckpt CKPT_DIR, "
            "--exported ARTIFACT or --params P.npz (a flax-layout npz; see "
            "`python -m ultrasound_modeling_tpu_torch.cli -h`) — otherwise "
            "the server would answer from random parameters")
    device = resolve_device(args.device)
    min_batch, max_batch = 1, args.max_batch
    if args.exported:
        from ultrasound_modeling_tpu_torch.infer.export import (
            load_exported_meta)
        _refuse_quantize_exported(args)
        fn, sample_shape, exported_batch = load_exported_meta(
            args.exported, device)
        if exported_batch is not None:
            # static-batch artifact: the only legal device batch is the
            # pinned size — collapse the padding buckets to exactly it
            min_batch = max_batch = exported_batch
            print(f"static-batch artifact: every device batch padded to "
                  f"{exported_batch}", flush=True)
        name, kind = os.path.basename(args.exported), "exported"
    else:
        cfg = build_config(args)
        mcfg = cfg.model
        h, w = mcfg.img_size
        sample_shape = (h, w, mcfg.in_channels)
        fn = _make_forward(mcfg, cfg.train, args.ckpt, device, args.quantize,
                           params=args.params)
        name = mcfg.name
        kind = (("bf16" if mcfg.compute_dtype == "bfloat16" else "f32")
                + (" int8 weights" if args.quantize else ""))
    server = InferenceServer(make_forward(fn, device), sample_shape,
                             host=args.host, port=args.port,
                             max_batch=max_batch, window_ms=args.window_ms,
                             model_name=name, min_batch=min_batch)
    host, port = server.address
    if args.warmup:
        print(f"warming {len(server.batcher.buckets)} batch buckets "
              f"{server.batcher.buckets} ...", flush=True)
        server.batcher.warmup(sample_shape)
    print(f"serving {name} ({kind}, {device}, frames {sample_shape}, "
          f"max_batch {max_batch}, window {args.window_ms} ms) on "
          f"http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def cmd_train(args):
    """Train (saving to ``--ckpt``, resuming with ``--resume``), print the
    final evaluation summary (empty when no epoch ran an evaluation, as in
    the JAX package) and return the Trainer."""
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    from ultrasound_modeling_tpu_torch.train.loop import Trainer
    from ultrasound_modeling_tpu_torch.utils.checkpoint import Checkpointer
    from ultrasound_modeling_tpu_torch.utils.logging import MetricLogger

    if args.resume and not args.ckpt:
        raise SystemExit("--resume restores from --ckpt CKPT_DIR")
    device = resolve_device(args.device)
    full_f32_matmuls()
    cfg = build_config(args)
    ckpt = (Checkpointer(args.ckpt, cfg.train.max_checkpoints_to_keep)
            if args.ckpt else None)
    trainer = Trainer(cfg, build_dataset(cfg, args, device), device=device,
                      logger=MetricLogger(args.log_dir), checkpointer=ckpt)
    if args.resume and ckpt.latest_step() is not None:
        trainer.restore(ckpt)
        print(f"resumed from step {trainer.iteration}", flush=True)
    summary = trainer.fit(args.epochs)
    print({k: round(v, 5) for k, v in summary.items()}, flush=True)
    return trainer


def cmd_eval(args):
    """Evaluate the model part of ``--ckpt`` (the seeded initial weights
    without it) on the test split; print and return the summary."""
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    from ultrasound_modeling_tpu_torch.train.loop import Trainer
    from ultrasound_modeling_tpu_torch.utils.checkpoint import Checkpointer
    from ultrasound_modeling_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    full_f32_matmuls()
    cfg = build_config(args)
    trainer = Trainer(cfg, build_dataset(cfg, args, device), device=device,
                      logger=MetricLogger(args.log_dir))
    if args.ckpt:
        model = trainer.model
        model.load_state_dict(Checkpointer(args.ckpt).restore(
            model.state_dict(), section="model"), strict=True)
    summary = trainer.evaluate(epoch=0)
    print({k: round(v, 5) for k, v in summary.items()}, flush=True)
    return summary


def cmd_infer(args):
    """End-to-end evaluator (the reference's TBIEvaluator product —
    reference: TBIEvaluator.py:163-373): optional brain-mask -> bleed
    cascade, per-scan cardiac batches from TestingPaths, the polar panel
    set and a per-class count summary (``summary.json``, the JAX package's
    keys)."""
    from ultrasound_modeling_tpu_torch.infer import evaluate as ev
    from ultrasound_modeling_tpu_torch.infer import render

    device = resolve_device(args.device)
    cfg = build_config(args)

    # -- test data: ETL'd archive (the reference's input product) or the
    #    dataset test split (synthetic smoke path).
    paths = bmode = None
    if args.archive:
        x, y, bmode, paths = ev.load_archive(args.archive)
    else:
        ds = build_dataset(cfg, args, torch.device("cpu"))
        x, y = ds.x_te.numpy(), ds.y_te.numpy()
    if args.select and paths is None:
        raise SystemExit(
            "--select filters by TestingPaths entries, which only an "
            "--archive input provides; the synthetic/test-split path has "
            "no frame paths")
    if args.select:
        # frame selection by patient/scan substring over TestingPaths —
        # the reference's findImage (TBIEvaluator.py:41-56)
        keep = np.array([args.select in str(p) for p in paths])
        if not keep.any():
            print(f"--select {args.select!r} matches no TestingPaths entry")
            return
        x, y = x[keep], y[keep]
        bmode = bmode[keep] if bmode is not None else None
        paths = [p for p, k in zip(paths, keep) if k]
    if args.max_frames:
        x, y = x[: args.max_frames], y[: args.max_frames]
        bmode = bmode[: args.max_frames] if bmode is not None else None
        paths = paths[: args.max_frames] if paths is not None else None

    sample_shape = tuple(x.shape[1:])
    exported_batch = None
    if args.exported:
        # serve an exported artifact: program and weights, no checkpoint or
        # model rebuild (infer/export.py); a static-batch export pins the
        # chunk size below to its batch
        from ultrasound_modeling_tpu_torch.infer.export import (
            load_exported_meta)
        _refuse_quantize_exported(args)
        bleed_fwd, exported_shape, exported_batch = load_exported_meta(
            args.exported, device)
        if sample_shape != tuple(exported_shape):
            raise SystemExit(
                f"--exported artifact was exported for frames shaped "
                f"{tuple(exported_shape)}, but the input provides "
                f"{sample_shape}; re-export for this archive or pass "
                f"matching data")
    else:
        bleed_fwd = _make_forward(cfg.model, cfg.train, args.ckpt, device,
                                  args.quantize)

    # -- optional cascade: the brain-mask model zeroes non-brain input
    #    before the bleed model runs (reference: TBIEvaluator.py:221-232)
    if args.cascade:
        cascade_family = args.cascade_model or args.model
        if cascade_family == cfg.model.name:
            brain_mcfg, brain_tcfg = cfg.model, cfg.train
        else:
            brain_def = default_config(cascade_family)
            brain_mcfg, brain_tcfg = brain_def.model, brain_def.train
        brain_mcfg = dataclasses.replace(
            brain_mcfg, num_classes=args.cascade_classes or 2)
        brain_fwd = _make_forward(brain_mcfg, brain_tcfg, args.cascade, device)
        forward_with_mask = ev.make_cascade(brain_fwd, bleed_fwd,
                                            return_mask=True)
    else:
        def forward_with_mask(b):
            return bleed_fwd(b), None

    out_dir = args.out or "inference_out"
    os.makedirs(out_dir, exist_ok=True)
    axes = None
    if args.axis_dir and os.path.isdir(args.axis_dir):
        axes = render.load_axes(args.axis_dir)
    if x.shape[0] == 0:
        print("no test frames in the input (empty archive/test split)")
        return
    bs = min(16, x.shape[0]) if exported_batch is None else exported_batch
    nc = cfg.model.num_classes

    # one forward pass in fixed-size batches: the last is padded to `bs`
    # by repeating its last frame (an eval-mode forward treats every frame
    # on its own, so padding changes no result)
    probs_chunks, mask_chunks = [], []
    n_total = x.shape[0]
    for start in range(0, n_total, bs):
        stop = min(start + bs, n_total)
        xb = np.asarray(x[start:stop], np.float32)
        pad = bs - xb.shape[0]
        if pad:
            xb = np.concatenate([xb, np.repeat(xb[-1:], pad, axis=0)], axis=0)
        probs, mk = forward_with_mask(torch.from_numpy(xb).to(device))
        probs_chunks.append(probs.float().cpu().numpy()[: stop - start])
        mask_chunks.append(
            mk.cpu().numpy()[: stop - start] if mk is not None else None)
    probs_all = np.concatenate(probs_chunks, axis=0)
    mask_all = (np.concatenate(mask_chunks, axis=0)
                if mask_chunks[0] is not None else None)

    def frame_names():
        """(index, panel name) per frame.  Cardiac mode numbers cycles
        within each scan (reference: TBIEvaluator.py:132-160) with a
        per-scan counter that survives non-consecutive groups."""
        if args.cardiac and paths is not None:
            cycle_no = {}
            for path, start, stop in ev.group_by_path(paths):
                key = str(path).strip("[]")
                for j in range(stop - start):
                    k = cycle_no.get(key, 0)
                    cycle_no[key] = k + 1
                    yield start + j, f"{key}_c{k:02d}"
        else:
            for i in range(n_total):
                yield i, (f"{str(paths[i]).strip(chr(39) + chr(34) + '[] ')}"
                          f"_{i:04d}"
                          if paths is not None else f"frame_{i:04d}")

    summary = {"frames": [], "totals": {}}
    for i, name in frame_names():
        p = probs_all[i]
        # composite (reference: TBIEvaluator.py:249-252) on the host
        comp = 1.0 - p[..., 0] - 0.5 * p[..., 1] + p[..., 2]
        counts = ev.class_counts(p, y[i], nc)
        render.render_panels(
            os.path.join(out_dir, f"{name}.png"), comp, y[i],
            prob_bleed=p[..., -1],
            bmode=bmode[i] if bmode is not None else None,
            mask=mask_all[i] if mask_all is not None else None, diff=True,
            confusion=counts["confusion"], axes=axes, title=name)
        summary["frames"].append({"name": name, **{
            k: (v.tolist() if hasattr(v, "tolist") else v)
            for k, v in counts.items()}})

    # aggregate per-class counts + confusion over the run
    tot_conf = np.sum([np.asarray(f["confusion"]) for f in summary["frames"]],
                      axis=0)
    summary["totals"] = {
        "pred_counts": np.sum([f["pred_counts"] for f in summary["frames"]],
                              axis=0).tolist(),
        "true_counts": np.sum([f["true_counts"] for f in summary["frames"]],
                              axis=0).tolist(),
        "confusion": tot_conf.tolist(),
        "pixel_accuracy": float(np.trace(tot_conf) / max(tot_conf.sum(), 1)),
    }
    with open(os.path.join(out_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"wrote {len(summary['frames'])} panels to {out_dir}")
    print(f"class counts (pred/true): "
          f"{summary['totals']['pred_counts']} / "
          f"{summary['totals']['true_counts']}  "
          f"pixel_acc={summary['totals']['pixel_accuracy']:.4f}")
    return summary


def cmd_export(args):
    """Write the restored eval forward as a ``torch.export`` artifact
    (``infer/export.py``), the analogue of the reference's end-of-training
    whole-model SavedModel save (reference: MainNumpy.py:177).  The
    artifact holds the weights; ``infer --exported`` and ``serve
    --exported`` (or ``infer.export.load_exported``) run it without the
    model code."""
    from ultrasound_modeling_tpu_torch.infer import export as ex

    if not args.ckpt and not args.init_random:
        # an artifact of random weights is never what a user wants unless
        # they say so explicitly
        raise SystemExit(
            "export needs trained weights: pass --ckpt CKPT_DIR (or "
            "--init-random to deliberately export freshly initialized "
            "parameters, e.g. for artifact plumbing tests)")
    device = resolve_device(args.device)
    cfg = build_config(args)
    mcfg = cfg.model
    h, w = mcfg.img_size
    sample_shape = (h, w, mcfg.in_channels)
    model = _restore_model(mcfg, cfg.train, args.ckpt, device)
    exported = ex.export_forward(mcfg, model, sample_shape,
                                 batch=args.batch or None,
                                 quantize=args.quantize)
    out = args.out or f"{mcfg.name}.pt2"
    ex.save_exported(exported, out)
    print(f"exported {mcfg.name} forward (batch={args.batch or 'symbolic'}, "
          f"{device}{', int8 weights' if args.quantize else ''}) -> {out} "
          f"({os.path.getsize(out)} bytes)", flush=True)
    return out


def _add_common(p) -> None:
    p.add_argument("--model", default="transunet", choices=PORTED,
                   help="model family (the --config TOML's [model] name "
                        "wins when given)")
    p.add_argument("--config", default=None,
                   help="TOML config file (overrides the family defaults)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="defaults to the config/family value (3)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="defaults to the config value (transunet 32, "
                        "vit 8, swin 32, resnest_unet 64, mobileunet 256)")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the initial weights and the augmentation")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay float32)")
    p.add_argument("--attn-train", default=None,
                   choices=("auto", "xla", "flash", "pallas"),
                   help="train-path attention: 'xla' = composed "
                        "attention, 'flash' = the K3 attention core with its "
                        "backward kernel, 'pallas' = the whole attention as "
                        "K5, whose forward saves qkv and the probabilities "
                        "for its backward; 'auto' (the vit default) "
                        "resolves to 'xla' off the TPU.  The swin "
                        "ignores it: it trains on K4 with its backward; "
                        "resnest_unet and mobileunet have no attention")
    p.add_argument("--ckpt", default=None, help="checkpoint directory")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data instead of .npy files")
    p.add_argument("--train-data", default=None)
    p.add_argument("--val-data", default=None)
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; refuses to start without a "
                        "card) or cpu")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ultrasound_modeling_tpu_torch.cli",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train a model")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=None,
                   help="defaults to the config value (50; resnest_unet "
                        "46, mobileunet 30)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint from --ckpt")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint on the test split")
    _add_common(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("infer", help="panels and class counts over a test "
                                     "archive (renders with matplotlib)")
    _add_common(p)
    p.add_argument("--out", default=None)
    p.add_argument("--axis-dir", default=None)
    p.add_argument("--archive", default=None, metavar="DIR",
                   help="ETL'd archive folder with TestingData.npy + "
                        "TestingPaths.npy (the reference evaluator's input "
                        "— TBIEvaluator.py:177-181)")
    p.add_argument("--cascade", default=None, metavar="BRAIN_CKPT",
                   help="brain-mask checkpoint dir: run the two-stage "
                        "brain-mask -> bleed cascade "
                        "(TBIEvaluator.py:221-232)")
    p.add_argument("--cascade-model", default=None, choices=PORTED,
                   help="model family of the brain-mask checkpoint "
                        "(default: same as --model)")
    p.add_argument("--cascade-classes", type=int, default=2,
                   help="num classes of the brain-mask model (default 2)")
    p.add_argument("--cardiac", action="store_true",
                   help="group test rows into per-scan cardiac-cycle "
                        "batches by TestingPaths (TBIEvaluator.py:132-160)")
    p.add_argument("--max-frames", type=int, default=0,
                   help="render at most N frames (0 = all)")
    p.add_argument("--exported", default=None, metavar="FILE",
                   help="run a `cli export` artifact instead of rebuilding "
                        "the model from --ckpt (weights embedded)")
    p.add_argument("--select", default=None, metavar="SUBSTR",
                   help="only frames whose TestingPaths entry contains "
                        "SUBSTR (patient/scan selection — the reference's "
                        "findImage, TBIEvaluator.py:41-56)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="int8 weight-only serving: kernels stored int8 with "
                        "per-channel scales, dequantized on the device "
                        "(infer/quantize.py)")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser(
        "export", help="write the forward as a torch.export artifact",
        description="Write the restored eval forward as a torch.export "
                    "artifact.  The JAX package's --platforms has no "
                    "counterpart: the artifact runs on the device its "
                    "weights were exported from (--device).")
    _add_common(p)
    p.add_argument("--out", default=None,
                   help="output artifact path (default <model>.pt2)")
    p.add_argument("--batch", type=int, default=0,
                   help="pin a static batch size (default 0 = symbolic "
                        "batch: one artifact serves any batch size)")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="embed int8 weights (per-channel scales, dequantized "
                        "on the device): ~4x smaller artifact than f32")
    p.add_argument("--init-random", action="store_true",
                   help="allow exporting without --ckpt (freshly "
                        "initialized weights — plumbing tests only)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("serve", help="HTTP inference with micro-batching")
    _add_common(p)
    p.add_argument("--params", default=None,
                   help="flax-layout npz (params/... and batch_stats/...)")
    p.add_argument("--exported", default=None, metavar="FILE",
                   help="serve a `cli export` artifact (weights embedded) "
                        "instead of rebuilding from --ckpt")
    p.add_argument("--quantize", default=None, choices=["int8"],
                   help="int8 weight-only serving from --ckpt or --params "
                        "(infer/quantize.py)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 = pick a free port (printed at startup)")
    p.add_argument("--max-batch", type=int, default=64)
    p.add_argument("--window-ms", type=float, default=2.0)
    p.add_argument("--warmup", action="store_true",
                   help="run every padding bucket once before serving")
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv=None):
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

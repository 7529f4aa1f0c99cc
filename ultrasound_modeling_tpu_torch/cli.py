"""Command-line interface of the PyTorch port: ``train`` and ``serve`` (the
other subcommands of the JAX package's cli are not ported yet).

Training mirrors the JAX package's ``cli train`` (default config, the
reference's schedule, clip and Adam)::

    python -m ultrasound_modeling_tpu_torch.cli train --synthetic \
        [--model {transunet,vit,swin,resnest_unet,mobileunet}] [--epochs N] \
        [--batch-size B] [--bf16] \
        [--attn-train {xla,flash,pallas}] [--seed S] [--device cuda]

Serving takes weights from the JAX side as a flax-layout npz
(``utils/checkpoint``)::

    # JAX side, from a restored TrainState `state`
    from ultrasound_modeling_tpu.utils.checkpoint import save_params_npz
    save_params_npz({"params": state.params,
                     "batch_stats": state.batch_stats}, "P.npz")
    # port
    python -m ultrasound_modeling_tpu_torch.cli serve \
        [--model {vit,swin,resnest_unet,mobileunet}] --params P.npz [--bf16]

The server is ``infer/server.py``, the port's copy of the JAX package's
(stdlib + numpy), over this port's forward; ``/predict`` takes float32 NHWC
frames of the family's shape (``[B, 256, 80, 10]``; the ResNeStUNet's
``[B, 256, 64, 6]``, the MobileUNet's ``[B, 256, 64, 15]``) and answers
float32 probabilities ``[B, H, W, 3]``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable

import numpy as np
import torch

from ultrasound_modeling_tpu_torch.config import default_config
from ultrasound_modeling_tpu_torch.device import resolve_device

# the model families this port builds: all five
PORTED = ("transunet", "vit", "swin", "resnest_unet", "mobileunet")


def build_serving_model(params_path: str, bf16: bool, device: torch.device,
                        model_name: str = "transunet") -> torch.nn.Module:
    """The family's default-config model with weights from a flax-layout
    npz."""
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    from ultrasound_modeling_tpu_torch.models.registry import build_model
    from ultrasound_modeling_tpu_torch.utils.checkpoint import load_params_npz

    full_f32_matmuls()
    mcfg = default_config(model_name).model
    if bf16:
        mcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16")
    model = build_model(mcfg)
    model.load_state_dict(load_params_npz(params_path, model.family),
                          strict=True)
    return model.to(device).eval()


def make_forward(model: torch.nn.Module, device: torch.device
                 ) -> Callable[[np.ndarray], np.ndarray]:
    """``x [B, H, W, C]`` float32 numpy -> float32 numpy probabilities."""
    def forward(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return model(xt.to(device)).float().cpu().numpy()
    return forward


def cmd_serve(args) -> None:
    from ultrasound_modeling_tpu_torch.infer.server import InferenceServer

    if not args.params:
        raise SystemExit(
            "serve needs trained weights: pass --params P.npz (a flax-layout "
            "npz; see `python -m ultrasound_modeling_tpu_torch.cli -h`) — "
            "otherwise the server would answer from random parameters")
    device = resolve_device(args.device)
    model = build_serving_model(args.params, args.bf16, device, args.model)
    mcfg = default_config(args.model).model
    h, w = mcfg.img_size
    sample_shape = (h, w, mcfg.in_channels)
    server = InferenceServer(make_forward(model, device), sample_shape,
                             host=args.host, port=args.port,
                             max_batch=args.max_batch,
                             window_ms=args.window_ms, model_name=args.model)
    host, port = server.address
    if args.warmup:
        print(f"warming {len(server.batcher.buckets)} batch buckets "
              f"{server.batcher.buckets} ...", flush=True)
        server.batcher.warmup(sample_shape)
    print(f"serving {args.model} ({'bf16' if args.bf16 else 'f32'}, {device}, "
          f"frames {sample_shape}, max_batch {args.max_batch}, window "
          f"{args.window_ms} ms) on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def build_config(args):
    """The family's default config with the command line's overrides."""
    cfg = default_config(args.model)
    model, train = cfg.model, cfg.train
    if args.bf16:
        model = dataclasses.replace(model, compute_dtype="bfloat16")
    if args.attn_train:
        model = dataclasses.replace(model, attn_train_impl=args.attn_train)
    if args.batch_size:
        train = dataclasses.replace(train, batch_size=args.batch_size)
    if args.seed is not None:
        train = dataclasses.replace(train, seed=args.seed)
    if args.epochs:
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


def cmd_train(args):
    """Train, print the final evaluation summary (empty when no epoch ran
    an evaluation, as in the JAX package) and return the Trainer."""
    from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
    from ultrasound_modeling_tpu_torch.train.loop import Trainer
    from ultrasound_modeling_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    full_f32_matmuls()
    cfg = build_config(args)
    trainer = Trainer(cfg, build_dataset(cfg, args, device), device=device,
                      logger=MetricLogger(args.log_dir))
    summary = trainer.fit(args.epochs)
    print({k: round(v, 5) for k, v in summary.items()}, flush=True)
    return trainer


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ultrasound_modeling_tpu_torch.cli",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train a model (default config)")
    t.add_argument("--model", default="transunet", choices=PORTED,
                   help="model family (the ported ones)")
    t.add_argument("--epochs", type=int, default=None,
                   help="defaults to the config value (50; resnest_unet "
                        "46, mobileunet 30)")
    t.add_argument("--batch-size", type=int, default=None,
                   help="defaults to the config value (transunet 32, "
                        "vit 8, swin 32, resnest_unet 64, mobileunet 256)")
    t.add_argument("--seed", type=int, default=None,
                   help="seed of the initial weights and the augmentation")
    t.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay float32)")
    t.add_argument("--attn-train", default=None,
                   choices=("auto", "xla", "flash", "pallas"),
                   help="train-path attention: 'xla' = composed "
                        "attention, 'flash' = the K3 attention core with its "
                        "backward kernel, 'pallas' = the whole attention as "
                        "K5, whose forward saves qkv and the probabilities "
                        "for its backward; 'auto' (the vit default) "
                        "resolves to 'xla' off the TPU.  The swin "
                        "ignores it: it trains on K4 with its backward; "
                        "resnest_unet and mobileunet have no attention")
    t.add_argument("--synthetic", action="store_true",
                   help="synthetic data instead of .npy files")
    t.add_argument("--train-data", default=None)
    t.add_argument("--val-data", default=None)
    t.add_argument("--log-dir", default="logs")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train)
    p = sub.add_parser("serve", help="HTTP inference with micro-batching")
    p.add_argument("--model", default="transunet", choices=PORTED,
                   help="model family of the weights (the ported ones)")
    p.add_argument("--params", default=None,
                   help="flax-layout npz (params/... and batch_stats/...)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (params stay float32)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
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

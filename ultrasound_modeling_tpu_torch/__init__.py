"""ultrasound_modeling_tpu_torch — the PyTorch/CUDA port of
``ultrasound_modeling_tpu``, targeting one NVIDIA H100 (Hopper, sm_90a).

The JAX package stays the reference; each module here has its counterpart
at the same path there, and the tests hold the two against each other on the
same weights and inputs.  This package imports ``torch`` and never ``jax``.

Layout (mirrors the JAX package):
  models/common.py      — convs, norms (BatchNorm train and eval),
                          activations (NHWC public layout)
  models/resnest.py     — ResNeSt split-attention encoder (fused stages;
                          K2 on the train route)
  models/transunet.py   — TransUNet, train and eval
  models/registry.py    — build_model
  ops/attention.py      — mha with the reference's 1/sqrt(heads) scale
  ops/window_attn.py    — relative-position index, shifted mask, plain
                          window attention
  ops/kernels.py        — hand-written CUDA kernels (csrc/) + their plain
                          PyTorch versions and launch counters; K1 and
                          K4's forward as custom ops (torch.export)
  data/                 — label2vec, batched augmentation, the Dataset
                          cursor, synthetic data
  train/                — cce_smooth, metrics, clip + Adam, train / eval
                          steps, Trainer
  utils/checkpoint.py   — flax-npz <-> torch state_dict bridge,
                          Checkpointer (save / restore / resume)
  utils/logging.py      — MetricLogger (JSONL + TensorBoard scalars)
  infer/server.py       — the micro-batching HTTP InferenceServer
  infer/evaluate.py     — batched inference, the brain->bleed cascade,
                          class counts, the test-archive loader
  infer/quantize.py     — int8 weight-only serving (flax-layout scales)
  infer/export.py       — torch.export artifacts of the eval forward
  infer/render.py       — the polar panels (matplotlib, host only)
  config.py             — the config dataclasses, default_config, from_toml
  device.py             — resolve_device: the card unless the CPU is asked
  cli.py                — ``train``, ``eval``, ``infer``, ``export``,
                          ``serve``

The port imports nothing of the JAX package: ``config.py``,
``infer/server.py``, ``infer/render.py`` and ``utils/logging.py`` are its
own copies of the framework-free modules there (``tests/test_torch_port_isolation.py``
enforces the rule and holds the copies against the originals).
"""

__version__ = "0.1.0"

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
                          PyTorch versions and launch counters
  data/                 — label2vec, batched augmentation, the Dataset
                          cursor, synthetic data
  train/                — cce_smooth, metrics, clip + Adam, train / eval
                          steps, Trainer
  utils/checkpoint.py   — flax-npz <-> torch state_dict bridge
  cli.py                — ``train``, ``serve``

Shared with the JAX package, imported as they are (none imports jax):
``ultrasound_modeling_tpu.config``, ``ultrasound_modeling_tpu.infer.server``
and ``ultrasound_modeling_tpu.utils.logging``.
"""

__version__ = "0.1.0"

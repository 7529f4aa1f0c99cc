"""The port's serving path: the port's HTTP server over the port's forward,
in a fresh interpreter that must never import jax or flax, and the cli's
refusals (no weights; a CUDA request without a card)."""

import os
import subprocess
import sys

import pytest
import torch

from ultrasound_modeling_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SERVE_SCRIPT = r"""
import io, json, sys, threading, urllib.request
import numpy as np, torch
from ultrasound_modeling_tpu_torch.infer.server import InferenceServer
from ultrasound_modeling_tpu_torch.cli import make_forward
from ultrasound_modeling_tpu_torch.models.transunet import TransUNet
from ultrasound_modeling_tpu_torch.utils.checkpoint import (
    from_flax, random_flax_variables)

torch.set_num_threads(2)
m = TransUNet(num_classes=3, hidden_size=64, num_heads=4, num_layers=2,
              mlp_dim=128, grid=(4, 5), radix=2, kpaths=2)
m.load_state_dict(from_flax(random_flax_variables(m, seed=0)),
                  strict=True)
srv = InferenceServer(make_forward(m.eval(), torch.device("cpu")),
                      (64, 80, 10), port=0, max_batch=4, window_ms=20.0)
srv.start_background()
host, port = srv.address
rng = np.random.default_rng(1)
x1 = rng.standard_normal((64, 80, 10)).astype(np.float32)
x2 = rng.standard_normal((2, 64, 80, 10)).astype(np.float32)
out = {}

def post_npy():
    buf = io.BytesIO(); np.save(buf, x1)
    req = urllib.request.Request(f"http://{host}:{port}/predict", data=buf.getvalue(),
                                 headers={"Content-Type": "application/octet-stream"})
    out["npy"] = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=120).read()))

def post_json():
    body = json.dumps({"instances": x2.tolist()}).encode()
    req = urllib.request.Request(f"http://{host}:{port}/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    out["json"] = json.loads(urllib.request.urlopen(req, timeout=120).read())

ts = [threading.Thread(target=f) for f in (post_npy, post_json)]
[t.start() for t in ts]; [t.join() for t in ts]
stats = json.loads(urllib.request.urlopen(f"http://{host}:{port}/stats").read())
srv.shutdown()
p1 = out["npy"]; p2 = np.asarray(out["json"]["probabilities"], np.float32)
assert p1.shape == (64, 80, 3) and p1.dtype == np.float32, p1.shape
assert p2.shape == (2, 64, 80, 3), p2.shape
assert np.array(out["json"]["classes"]).shape == (2, 64, 80)
for p in (p1, p2):
    assert np.isfinite(p).all() and np.allclose(p.sum(-1), 1.0, atol=1e-5)
with torch.inference_mode():
    want = m(torch.from_numpy(x1[None])).numpy()[0]
assert np.abs(p1 - want).max() < 1e-5
assert stats["requests"] == 2 and stats["frames"] == 3, stats
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax"))
assert not bad, bad
print("SERVE_OK")
"""


def test_serve_two_requests_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _SERVE_SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "SERVE_OK" in proc.stdout


def test_serve_without_params_refuses():
    with pytest.raises(SystemExit, match="--params"):
        cli.main(["serve", "--device", "cpu"])


def test_cuda_device_without_card_raises(monkeypatch, tmp_path):
    """`--device cuda` on a machine without a card raises instead of
    quietly serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--params", str(tmp_path / "p.npz"),
                  "--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.resolve_device("cuda:0")
    assert cli.resolve_device("cpu") == torch.device("cpu")


def test_build_model_names_unported_families():
    """No family is left unported: the registry builds all five of the JAX
    package's (the last two, the ResNeStUNet and the MobileUNet, since
    ROADMAP Queue 1 items 7 and 8 were done) and refuses an unknown name."""
    import dataclasses
    from ultrasound_modeling_tpu.config import default_config
    from ultrasound_modeling_tpu.models.registry import MODEL_NAMES
    from ultrasound_modeling_tpu_torch.models.registry import build_model
    for name in ("resnest_unet", "mobileunet"):
        assert build_model(default_config(name).model).family == name
    assert set(MODEL_NAMES) == {"transunet", "vit", "swin", "resnest_unet",
                                "mobileunet"}
    with pytest.raises(KeyError, match="unknown model"):
        build_model(dataclasses.replace(default_config("transunet").model,
                                        name="ksac_unet"))
    m = build_model(default_config("transunet").model)
    assert m.encoder.attn_impl == "kernel"
    assert len(m.encoder.blocks) == 8 and m.compute_dtype == torch.float32

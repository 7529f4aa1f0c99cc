"""The port's serving commands end to end on the CPU, at the tiny
TransUNet config: ``cli infer`` over an ETL'd archive (cascade, cardiac
grouping, int8, the panels and a ``summary.json`` with the JAX package's
keys), ``cli export`` (its refusal without weights, an ``--init-random``
artifact that ``infer --exported`` serves, the int8 artifact under 0.45x
the f32 one), ``cli serve --ckpt --quantize int8`` answering a request, and
every new subcommand's refusal of ``--device cuda`` without a card."""

import io
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu_torch import cli
from ultrasound_modeling_tpu_torch.config import from_toml
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.infer.server import InferenceServer
from ultrasound_modeling_tpu_torch.train.loop import Trainer
from ultrasound_modeling_tpu_torch.utils.checkpoint import Checkpointer
from ultrasound_modeling_tpu_torch.utils.logging import MetricLogger
from test_torch_evaluate import (  # noqa: F401  (two_threads: autouse)
    H, W, two_threads, write_toml)

# the keys of the JAX package's summary.json (its cli.cmd_infer)
FRAME_KEYS = {"name", "pred_counts", "true_counts", "confusion"}
TOTAL_KEYS = {"pred_counts", "true_counts", "confusion", "pixel_accuracy"}


@pytest.fixture(scope="module")
def toml(tmp_path_factory):
    return write_toml(tmp_path_factory.mktemp("cfg"))


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    d = tmp_path_factory.mktemp("arch")
    rng = np.random.default_rng(0)
    n = 4
    raw = rng.normal(size=(n, 1, H, W, 12)).astype(np.float32)
    raw[..., 0] = rng.uniform(0, 2, size=(n, 1, H, W))  # scalar soft label
    np.save(d / "TestingData.npy", raw)
    np.save(d / "TestingPaths.npy",
            np.array([["scanA"], ["scanA"], ["scanA"], ["scanB"]]))
    return str(d)


def _make_ckpt(directory, toml, num_classes, seed):
    """A checkpoint of a Trainer's initial state (seeded weights)."""
    import dataclasses
    cfg = from_toml(toml)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                num_classes=num_classes),
                      train=dataclasses.replace(cfg.train, seed=seed))
    ds = Dataset.synthetic(n_train=2, n_test=2, height=H, width=W,
                           num_classes=num_classes, device="cpu")
    ck = Checkpointer(str(directory))
    Trainer(cfg, ds, device="cpu", logger=MetricLogger(str(directory)),
            checkpointer=ck).save()
    return str(directory)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, toml):
    d = tmp_path_factory.mktemp("ckpts")
    return (_make_ckpt(d / "bleed", toml, 3, seed=1),
            _make_ckpt(d / "brain", toml, 2, seed=2))


def _summary(out):
    with open(os.path.join(out, "summary.json")) as fh:
        return json.load(fh)


def _check_summary(summary, n, nc=3):
    assert set(summary) == {"frames", "totals"}
    assert len(summary["frames"]) == n
    assert all(set(f) == FRAME_KEYS for f in summary["frames"])
    tot = summary["totals"]
    assert set(tot) == TOTAL_KEYS
    conf = np.asarray(tot["confusion"])
    assert conf.shape == (nc, nc) and conf.sum() == n * H * W
    assert sum(tot["pred_counts"]) == n * H * W
    assert 0.0 <= tot["pixel_accuracy"] <= 1.0


def _infer(toml, archive, out, *extra):
    return cli.main(["infer", "--config", toml, "--device", "cpu",
                     "--archive", archive, "--out", str(out), *extra])


def test_infer_cli_cascade_cardiac(tmp_path, toml, archive, ckpts):
    bleed, brain = ckpts
    out = tmp_path / "panels"
    summary = _infer(toml, archive, out, "--ckpt", bleed, "--cascade", brain,
                     "--cardiac")
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    # per-cycle panels named by scan (3 cycles of scanA + 1 of scanB)
    assert pngs == ["scanA_c00.png", "scanA_c01.png", "scanA_c02.png",
                    "scanB_c00.png"]
    assert _summary(out) == json.loads(json.dumps(summary))
    _check_summary(summary, 4)
    plain = _infer(toml, archive, tmp_path / "plain", "--ckpt", bleed)
    assert plain["totals"] != summary["totals"]   # the mask changed inputs


def test_infer_cli_int8_and_max_frames(tmp_path, toml, archive, ckpts):
    out = tmp_path / "int8"
    summary = _infer(toml, archive, out, "--ckpt", ckpts[0], "--quantize",
                     "int8", "--max-frames", "2")
    assert len([f for f in os.listdir(out) if f.endswith(".png")]) == 2
    _check_summary(summary, 2)
    assert [f["name"] for f in summary["frames"]] == ["scanA_0000",
                                                      "scanA_0001"]


def test_export_refuses_without_weights(tmp_path, toml):
    with pytest.raises(SystemExit, match="--init-random"):
        cli.main(["export", "--config", toml, "--device", "cpu",
                  "--out", str(tmp_path / "m.pt2")])


def test_export_artifacts_serve_and_int8_is_smaller(tmp_path, toml, archive):
    """An --init-random artifact (symbolic batch) serves `infer --exported`
    with the same results as `infer` on the same seeded weights (2 frames);
    an int8 artifact pinned at batch 3 serves 4 frames in padded chunks of
    3 and is under 0.45x the f32 artifact."""
    f32 = cli.main(["export", "--config", toml, "--device", "cpu",
                    "--init-random", "--out", str(tmp_path / "f32.pt2")])
    int8 = cli.main(["export", "--config", toml, "--device", "cpu",
                     "--init-random", "--quantize", "int8", "--batch", "3",
                     "--out", str(tmp_path / "int8.pt2")])
    assert os.path.getsize(int8) < 0.45 * os.path.getsize(f32)
    served = _infer(toml, archive, tmp_path / "exported", "--exported", f32,
                    "--max-frames", "2")
    direct = _infer(toml, archive, tmp_path / "direct", "--max-frames", "2")
    assert served == direct
    _check_summary(served, 2)
    quant = _infer(toml, archive, tmp_path / "int8", "--exported", int8)
    _check_summary(quant, 4)
    with pytest.raises(SystemExit, match="export --quantize"):
        _infer(toml, archive, tmp_path / "x", "--exported", f32,
               "--quantize", "int8")


def test_serve_ckpt_int8_answers(monkeypatch, toml, ckpts):
    """`serve --ckpt D --quantize int8` (on the CPU) answers a request."""
    servers = []
    monkeypatch.setattr(InferenceServer, "serve_forever",
                        lambda self: (servers.append(self),
                                      self.start_background()))
    cli.main(["serve", "--config", toml, "--device", "cpu", "--ckpt",
              ckpts[0], "--quantize", "int8", "--port", "0",
              "--max-batch", "2"])
    (server,) = servers
    host, port = server.address
    x = np.random.default_rng(3).normal(size=(2, H, W, 10)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, x)
    try:
        req = urllib.request.Request(
            f"http://{host}:{port}/predict", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        probs = np.load(io.BytesIO(urllib.request.urlopen(req, timeout=120)
                                   .read()))
    finally:
        server.shutdown()
    assert probs.shape == (2, H, W, 3)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    cfg = from_toml(toml)
    want = cli._make_forward(cfg.model, cfg.train, ckpts[0],
                             torch.device("cpu"), "int8")(torch.from_numpy(x))
    np.testing.assert_allclose(probs, want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("argv", [
    ["train", "--synthetic", "--ckpt", "D"],
    ["eval", "--synthetic", "--ckpt", "D"],
    ["infer", "--synthetic"],
    ["export", "--init-random"],
    ["serve", "--ckpt", "D", "--quantize", "int8"],
    ["serve", "--exported", "A.pt2"]])
def test_subcommands_refuse_cuda_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)

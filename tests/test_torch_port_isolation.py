"""The port stands alone: no module of ``ultrasound_modeling_tpu_torch`` and
no line of ``chip_smoke.py`` imports jax, flax or the JAX package; its own
copies of the framework-free modules (config, server, logger) behave as
the originals do; and its entry points run on the card unless the caller
asks for the CPU."""

import ast
import dataclasses
import io
import json
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu import config as jconfig
from ultrasound_modeling_tpu.infer import server as jserver
from ultrasound_modeling_tpu.utils import logging as jlogging
from ultrasound_modeling_tpu_torch import config as tconfig
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.infer import server as tserver
from ultrasound_modeling_tpu_torch.train.loop import Trainer
from ultrasound_modeling_tpu_torch.utils import logging as tlogging

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ultrasound_modeling_tpu")
FAMILIES = ("transunet", "vit", "resnest_unet", "swin", "mobileunet")


def _port_sources():
    files = sorted((REPO / "ultrasound_modeling_tpu_torch").rglob("*.py"))
    return [p for p in files if "_build" not in p.parts] + [REPO / "chip_smoke.py"]


def _imports(tree):
    """Top-level module names of every import in ``tree`` (at any depth:
    imports inside functions count too)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 20, files
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        bad += [f"{path.relative_to(REPO)}:{line} imports {name}"
                for line, name in _imports(tree) if name in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_import_walk_catches_each_form():
    """The walk above sees plain, from-, nested and dynamic imports."""
    src = ("import jax.numpy as jnp\n"
           "def f():\n    from ultrasound_modeling_tpu.config import Config\n"
           "from ultrasound_modeling_tpu_torch import cli\n"
           "m = __import__('flax.linen')\n")
    names = [n for _, n in _imports(ast.parse(src))]
    assert [n for n in names if n in FORBIDDEN] == [
        "jax", "ultrasound_modeling_tpu", "flax"]


@pytest.mark.parametrize("family", FAMILIES)
def test_default_config_matches_the_jax_package(family):
    want = jconfig.default_config(family)
    got = tconfig.default_config(family)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for section in ("paths", "data", "model", "train", "mesh"):
        assert ([f.name for f in dataclasses.fields(getattr(got, section))]
                == [f.name for f in dataclasses.fields(getattr(want, section))])


def test_default_config_overrides_match():
    kw = dict(model=dict(hidden_size=64), train=dict(batch_size=4))
    for name in ("transunet", "vit"):
        got = tconfig.default_config(name)
        want = jconfig.default_config(name)
        got = got.replace(model=dataclasses.replace(got.model, **kw["model"]),
                          train=dataclasses.replace(got.train, **kw["train"]))
        want = want.replace(model=dataclasses.replace(want.model, **kw["model"]),
                            train=dataclasses.replace(want.train, **kw["train"]))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _forward(x):
    """A numpy stand-in for a model: per-pixel softmax of a fixed map."""
    w = np.linspace(-1.0, 1.0, x.shape[-1] * 3, dtype=np.float32)
    z = x @ w.reshape(x.shape[-1], 3)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _ask(module, frames):
    srv = module.InferenceServer(_forward, (6, 5, 4), host="127.0.0.1",
                                 port=0, max_batch=4, window_ms=1.0,
                                 model_name="stub")
    srv.start_background()
    host, port = srv.address
    url = f"http://{host}:{port}"
    try:
        buf = io.BytesIO()
        np.save(buf, frames)
        req = urllib.request.Request(
            f"{url}/predict", data=buf.getvalue(),
            headers={"Content-Type": "application/octet-stream"})
        npy = urllib.request.urlopen(req, timeout=60).read()
        req = urllib.request.Request(
            f"{url}/predict",
            data=json.dumps({"instances": frames[:2].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        js = json.loads(urllib.request.urlopen(req, timeout=60).read())
        health = json.loads(urllib.request.urlopen(f"{url}/healthz",
                                                   timeout=60).read())
        stats = json.loads(urllib.request.urlopen(f"{url}/stats",
                                                  timeout=60).read())
    finally:
        srv.shutdown()
    return np.load(io.BytesIO(npy)), js, health, stats


def test_inference_server_answers_like_the_original():
    frames = np.random.default_rng(0).standard_normal((3, 6, 5, 4)).astype(
        np.float32)
    got, got_js, got_h, got_s = _ask(tserver, frames)
    want, want_js, want_h, want_s = _ask(jserver, frames)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _forward(frames))
    assert got_js == want_js
    assert got_h == want_h
    assert ({k: v for k, v in got_s.items() if "ms" not in k}
            == {k: v for k, v in want_s.items() if "ms" not in k})


def test_metric_logger_writes_the_original_bytes(tmp_path, monkeypatch,
                                                 capsys):
    """The same scalars give the same scalars.jsonl and the same
    TensorBoard events file, byte for byte (clock and host fixed)."""
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    monkeypatch.setattr("socket.gethostname", lambda: "host")
    out = {}
    for name, module in (("port", tlogging), ("jax", jlogging)):
        d = tmp_path / name
        logger = module.MetricLogger(str(d))
        logger.scalars(1, {"train_loss": 0.75, "lr": 1e-3})
        logger.scalars(2, {"epoch": 1, "epoch_loss": np.float32(0.5)})
        logger.close()
        out[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
        out[name + "_echo"] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert out["port_echo"] == out["jax_echo"]
    assert set(out["port"]) == {"scalars.jsonl",
                                "events.out.tfevents.1234.host"}


def test_trainer_and_dataset_default_to_the_card(monkeypatch):
    """With no device given they ask for the card, and without one they
    raise the cli's error instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 4, 3, 2), np.float32)
    y = np.zeros((2, 4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Dataset(x, y, x, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Dataset.synthetic(n_train=2, n_test=2, height=8, width=8)
    path = REPO / "missing.npy"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Dataset.from_npy(str(path), str(path))
    cfg = tconfig.default_config("vit")
    ds = Dataset(x, y, x, y, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, ds)
    assert ds.x_tr.device.type == "cpu"


def test_entry_points_default_device_is_cuda():
    import inspect
    for fn in (Trainer.__init__, Dataset.__init__, Dataset.from_npy,
               Dataset.synthetic):
        assert inspect.signature(fn).parameters["device"].default == "cuda"

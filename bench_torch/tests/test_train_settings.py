"""The reference train step follows the configuration's own train settings
(loss and smoothing, clip, L2) and refuses by name those it has no plain
version of."""

import json
import shutil
import time

import pytest
import torch

import run
from conftest import TINY_CELLS, _config
from harness import check, drive, program
from harness.cell import load_cell
from reference.train import Settings, train_settings

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
TODAY = Settings(label_smoothing=0.1, clip_global_norm=1.0,
                 l2_regularization=0.0)


def _steps(cell, seed=SEED):
    mix = cell.traffic
    weights = drive.weights_for(cell, seed, CPU)
    lrs = [1e-3] * drive.FOLLOWED
    return drive.reference_steps(cell, "f32", weights, seed, int(mix["batch"]),
                                 int(mix["batches"]), lrs, CPU)


def test_swin_settings_are_todays():
    assert train_settings(_config("swin")) == TODAY


def test_swin_follow_is_bit_equal_to_todays_constants(tiny_root, monkeypatch):
    cell = load_cell(tiny_root, "tiny_s.train")
    from_config = _steps(cell)
    monkeypatch.setattr(check, "train_settings", lambda cfg: TODAY)
    assert _steps(cell) == from_config


@pytest.fixture
def l2_checkout(tiny_root, tmp_path):
    """The tiny Swin train cell again, its configuration with L2 1e-3."""
    root = tmp_path / "checkout"
    shutil.copytree(tiny_root, root)
    cfg = _config("swin")
    cfg["train"]["l2_regularization"] = 1e-3
    base = root / "bench_torch"
    (base / "configs" / "tiny_swin_l2.json").write_text(json.dumps(cfg))
    limits = {c[0]: c[3] for c in TINY_CELLS}["tiny_s.train"]
    (base / "checks" / "tiny_s_l2.train.json").write_text(
        json.dumps({"limits": limits}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_swin_l2", "source": "test",
                             "reduced": [], "why": "test",
                             "file": "bench_torch/configs/tiny_swin_l2.json"})
    bench["workloads"].append({"name": "tiny_s_l2.train",
                               "config": "tiny_swin_l2",
                               "traffic": "tiny_train", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _run(root, name):
    cell = load_cell(root, name)
    return run.run(cell, SEED, 0.5, False, CPU, time.perf_counter())


def test_l2_is_followed(l2_checkout):
    out = _run(l2_checkout, "tiny_s_l2.train")
    assert out["correct"], out["checks"]


def test_l2_left_out_of_the_reference_fails(l2_checkout, monkeypatch):
    monkeypatch.setattr(check, "train_settings",
                        lambda cfg: Settings(0.1, 1.0, 0.0))
    out = _run(l2_checkout, "tiny_s_l2.train")
    assert not out["correct"], out["checks"]


def test_l2_weights_are_the_programs_l2_kernels():
    from ultrasound_modeling_tpu_torch.train.losses import l2_kernels
    from reference.numerics import Numerics
    from reference.swin import MODEL

    cfg = _config("swin")
    ref = MODEL(cfg["model"], Numerics("f32"))
    prog = program.build_model(cfg, ref.state_dict(), CPU)

    def names(model, params):
        by_id = {id(p): n for n, p in model.named_parameters()}
        return sorted(by_id[id(p)] for p in params)

    want = names(prog, l2_kernels(prog))
    assert want and names(ref, ref.l2_weights()) == want


@pytest.mark.parametrize("change, key", [
    ({"train": {"loss": "pixelcnn"}}, "train.loss"),
    ({"model": {"name": "mobileunet"}}, "model.name"),
    ({"train": {"weight_decay": 0.01}}, "train.weight_decay"),
    ({"train": {"class_factor": [1.0, 2.0, 3.0]}}, "train.class_factor"),
    ({"data": {"aug_flip": True}}, "data.aug_flip"),
])
def test_a_setting_without_a_plain_version_is_refused(change, key):
    cfg = _config("swin")
    for section, value in change.items():
        if isinstance(value, dict):
            cfg[section].update(value)
        else:
            cfg[section] = value
    with pytest.raises(NotImplementedError, match=key):
        train_settings(cfg)

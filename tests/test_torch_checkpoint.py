"""Checkpoint and resume of the port (``utils/checkpoint.Checkpointer``,
``train/loop.Trainer.restore``, ``cli train --ckpt/--resume``, ``cli
eval``): a save restores bit-equal (generator states included), only the
newest ``max_to_keep`` stay, restore refuses a file that does not fit its
template and casts only float leaves (saying so), and a run restored after
one epoch ends bit-equal to the run that never stopped.

The tiny TransUNet trains at learning rate 1.0 with an evaluation every
epoch, where epoch 2's F1 falls below epoch 1's: the plateau rule decays
the learning rate inside the run, so the resumed run must carry the
plateau scale and the last F1 (the JAX checkpoint holds neither)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu_torch import cli
from ultrasound_modeling_tpu_torch.config import from_toml
from ultrasound_modeling_tpu_torch.data import synthetic
from ultrasound_modeling_tpu_torch.data.pipeline import Dataset
from ultrasound_modeling_tpu_torch.train.loop import Trainer
from ultrasound_modeling_tpu_torch.utils.checkpoint import Checkpointer
from ultrasound_modeling_tpu_torch.utils.logging import MetricLogger
from test_torch_evaluate import (  # noqa: F401  (two_threads: autouse)
    H, W, two_threads, write_toml)


@pytest.fixture(scope="module")
def toml(tmp_path_factory):
    return write_toml(tmp_path_factory.mktemp("cfg"))


def _cfg(toml, **train):
    cfg = from_toml(toml)
    kw = dict(batch_size=8, learning_rate=1.0, log_every=1000)
    kw.update(train)
    return cfg.replace(train=dataclasses.replace(cfg.train, **kw))


def _trainer(cfg, log_dir, checkpointer=None, n_train=16):
    """A Trainer on 16 synthetic frames (epochs of 2 steps at batch 8) and
    8 test frames."""
    ds = Dataset.synthetic(n_train=n_train, n_test=8, height=H, width=W,
                           device="cpu")
    return Trainer(cfg, ds, device="cpu", logger=MetricLogger(str(log_dir)),
                   checkpointer=checkpointer)


def _flat(state, prefix=""):
    """Every leaf of a checkpoint state, by path."""
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(state, (list, tuple)):
        out = {}
        for i, v in enumerate(state):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: state}


def _clone(state):
    """A copy of a checkpoint state that later steps cannot change."""
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [_clone(v) for v in state]
    return state.clone() if isinstance(state, torch.Tensor) else state


def assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
        else:
            assert type(v) is type(fb[k]) and v == fb[k], k


@pytest.fixture(scope="module")
def one_epoch(toml, tmp_path_factory):
    """A run stopped after one epoch: its checkpoint directory and its
    state at the stop."""
    d = tmp_path_factory.mktemp("ckpt")
    t = _trainer(_cfg(toml), d / "logs", Checkpointer(str(d / "ck")))
    t.fit(1)
    return str(d / "ck"), _clone(t.checkpoint_state())


def test_checkpoint_round_trip_is_bit_equal(one_epoch, toml, tmp_path):
    ckpt_dir, saved = one_epoch
    ck = Checkpointer(ckpt_dir)
    assert ck.latest_step() == 2
    fresh = _trainer(_cfg(toml), tmp_path)
    before = _clone(fresh.checkpoint_state())
    fresh.restore(ck)
    assert_states_equal(fresh.checkpoint_state(), saved)
    assert fresh.iteration == 2 and fresh.state.step == 2
    # the fresh trainer's own state differed: the restore moved every part
    key = "encoder.encoder_norm.weight"
    assert not torch.equal(before["model"][key], saved["model"][key])
    assert not torch.equal(before["gen"], saved["gen"])
    assert before["opt"]["count"] == 0 and saved["opt"]["count"] == 2


def test_resume_equals_the_uninterrupted_run(one_epoch, toml, tmp_path):
    """2 epochs in one Trainer == 1 epoch, a restore into a fresh Trainer
    and dataset, then 1 more: every parameter and statistic, both moments,
    the step, both generators, the plateau scale and the F1, bit-equal."""
    ckpt_dir, _ = one_epoch
    whole = _trainer(_cfg(toml), tmp_path / "whole")
    whole.fit(2)
    assert whole.plateau_scale == 0.2    # epoch 2's F1 fell below epoch 1's
    resumed = _trainer(_cfg(toml), tmp_path / "resumed")
    resumed.restore(Checkpointer(ckpt_dir))
    resumed.fit(1)
    assert_states_equal(resumed.checkpoint_state(), whole.checkpoint_state())
    assert resumed.iteration == whole.iteration == 4


def test_trainer_saves_at_the_jax_condition(toml, tmp_path):
    """Saves after every epoch that crosses a multiple of
    checkpoint_every_steps (epochs of 2 steps, every 3: after steps 4 and
    6) and at the end; the newest max_to_keep stay."""
    cfg = _cfg(toml, batch_size=2, checkpoint_every_steps=3)
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=3)
    saved = []
    orig = ck.save
    ck.save = lambda state, step: (saved.append(step), orig(state, step))
    _trainer(cfg, tmp_path, ck, n_train=4).fit(3)
    assert saved == [4, 6, 6]
    assert ck.steps() == [4, 6]


def test_max_to_keep(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (1, 5, 3, 7):
        ck.save({"w": torch.full((2,), float(step)), "step": step}, step)
    assert ck.steps() == [5, 7] and ck.latest_step() == 7
    template = {"w": torch.zeros(2), "step": 0}
    assert ck.restore(template)["step"] == 7
    assert torch.equal(ck.restore(template, step=5)["w"], torch.full((2,), 5.0))
    with pytest.raises(FileNotFoundError):
        ck.restore(template, step=1)


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        Checkpointer(str(tmp_path)).restore({"a": torch.zeros(1)})


def _saved(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save({"w": torch.arange(6.0).reshape(2, 3),
             "ids": torch.arange(4, dtype=torch.int64),
             "sub": {"g": torch.ones(3, dtype=torch.uint8)},
             "n": 3, "f": 0.5, "none": None}, 10)
    return ck, {"w": torch.zeros(2, 3), "ids": torch.zeros(4, dtype=torch.int64),
                "sub": {"g": torch.zeros(3, dtype=torch.uint8)},
                "n": 0, "f": 0.0, "none": None}


def test_restore_checks_the_template(tmp_path, capsys):
    ck, template = _saved(tmp_path)
    got = ck.restore(template)
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3))
    assert (got["n"], got["f"], got["none"]) == (3, 0.5, None)
    assert capsys.readouterr().out == ""

    bad_shape = dict(template, w=torch.zeros(3, 2))
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad_shape)
    bad_int = dict(template, ids=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="dtype"):
        ck.restore(bad_int)
    with pytest.raises(TypeError, match="dtype"):
        ck.restore(dict(template, sub={"g": torch.zeros(3)}))
    with pytest.raises(TypeError):
        ck.restore(dict(template, n=0.0))
    with pytest.raises(KeyError, match="missing"):
        ck.restore(dict(template, extra=torch.zeros(1)))
    with pytest.raises(KeyError, match="extra"):
        ck.restore({k: v for k, v in template.items() if k != "f"})


def test_restore_casts_a_float_leaf_and_says_so(tmp_path, capsys):
    ck, template = _saved(tmp_path)
    got = ck.restore(dict(template, w=torch.zeros(2, 3, dtype=torch.bfloat16)))
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3).bfloat16())
    out = capsys.readouterr().out.strip().splitlines()
    assert out == ["restore: cast /w from torch.float32 to torch.bfloat16"]


def test_restore_section_takes_one_part(tmp_path):
    ck, template = _saved(tmp_path)
    got = ck.restore({"g": torch.zeros(3, dtype=torch.uint8)}, section="sub")
    assert torch.equal(got["g"], torch.ones(3, dtype=torch.uint8))


@pytest.fixture(scope="module")
def npy(tmp_path_factory):
    """ETL-layout train (8 frames) and test (4 frames) files, so that the
    cli trains 2 steps of 4 an epoch."""
    d = tmp_path_factory.mktemp("npy")
    paths = []
    for name, n, seed in (("train", 8, 0), ("val", 4, 1)):
        path = str(d / f"{name}.npy")
        np.save(path, synthetic.make_raw_array(n, seed, H, W))
        paths.append(path)
    return paths


def _cli_args(toml, npy, *extra):
    return ["--config", toml, "--train-data", npy[0], "--val-data", npy[1],
            "--batch-size", "4", "--device", "cpu", *extra]


def test_cli_train_resume_continues_the_step_count(toml, npy, tmp_path,
                                                   capsys):
    d = str(tmp_path / "ck")
    logs = str(tmp_path / "logs")
    first = cli.main(["train", *_cli_args(toml, npy, "--epochs", "1",
                                          "--ckpt", d, "--log-dir", logs)])
    assert first.iteration == 2 and Checkpointer(d).steps() == [2]
    capsys.readouterr()
    second = cli.main(["train", *_cli_args(toml, npy, "--epochs", "1",
                                           "--ckpt", d, "--resume",
                                           "--log-dir", logs)])
    assert "resumed from step 2" in capsys.readouterr().out
    assert second.iteration == second.state.step == 4
    assert Checkpointer(d).steps() == [2, 4]
    with pytest.raises(SystemExit, match="--ckpt"):
        cli.main(["train", *_cli_args(toml, npy, "--resume")])


def test_cli_eval_prints_a_finite_summary(one_epoch, toml, npy, tmp_path,
                                          capsys):
    ckpt_dir, _ = one_epoch
    args = _cli_args(toml, npy, "--log-dir", str(tmp_path))
    summary = cli.main(["eval", *args, "--ckpt", ckpt_dir])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed.startswith("{'precision'")
    assert summary and all(math.isfinite(v) for v in summary.values())
    assert 0.0 <= summary["f1"] <= 1.0
    # the model part alone was restored: the checkpoint's weights evaluate
    assert cli.main(["eval", *args, "--ckpt", ckpt_dir]) == summary
    assert cli.main(["eval", *args]) != summary

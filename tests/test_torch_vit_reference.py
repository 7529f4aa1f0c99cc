"""The port's pure ViT held against the benchmark's plain reference
(``bench_torch/reference/vit.py``) on the CPU, at a tiny size that still
tiles, on the benchmark's seeded weights (``harness/weights.py``): the eval
forward of each route, three train steps of the ``flash`` route through
the benchmark's trainer (``harness/program.trainer``) against the reference
step (``reference/train.follow``), the leaves the L2 penalty takes, and the
configuration file's parameter and product counts at full width.

The reference is loaded as the benchmark loads it (``harness/cell
.load_reference``, by path), with ``bench_torch`` on ``sys.path``."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "bench_torch"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import check, drive, program  # noqa: E402
from harness.cell import Cell, load_reference  # noqa: E402
from reference.numerics import Numerics  # noqa: E402

from ultrasound_modeling_tpu_torch.models.registry import build_model  # noqa: E402
from ultrasound_modeling_tpu_torch.ops import kernels as K  # noqa: E402
from ultrasound_modeling_tpu_torch.train import losses  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 1919       # larger than 32 signed bits hold
CONFIG = json.loads((BENCH / "configs" / "vit.json").read_text())
TINY = {"img_size": [32, 16], "vit_grid": [4, 4], "vit_hidden": 64,
        "vit_heads": 4, "vit_layers": 2, "mlp_dim": 128}
# f32 on both sides, so a gap is the round-off of another order of
# summation.  Over four seeds the CPU read at most 1.0e-7 (loss), 6.7e-7
# (first gradient) and 7.7e-6 (the change over three steps, which Adam's
# division amplifies where a gradient is small); rounding the products'
# operands to TF32 read at least 2.8e-5, 6.9e-4 and 4.4e-4.  Each
# tolerance sits 6-20x above the first and 9-140x below the second.
TOL = {"loss_rel": 2e-6, "grad_norm_gap": 5e-6, "update_norm_gap": 5e-5}
# probabilities, f32 on both sides: the CPU reads 0.0 on every route
EVAL_TOL = 2e-6


def _tiny_config() -> dict:
    cfg = json.loads(json.dumps(CONFIG))
    cfg["model"].update(TINY)
    return cfg


def _cell(cfg: dict) -> Cell:
    return Cell(name="vit.tiny", chips=1, config_name="vit", config=cfg,
                traffic_name="tiny", traffic={"kind": "train", "batch": 4,
                                              "batches": 4},
                limits=dict(TOL), end_to_end=[], per_layer=[], root=REPO,
                reference=load_reference(REPO, cfg["family"]))


@pytest.fixture(scope="module")
def cell():
    return _cell(_tiny_config())


@pytest.fixture(scope="module")
def weights(cell):
    return drive.weights_for(cell, SEED, CPU)


@pytest.mark.parametrize("route", ["composed", "plain", "kernel"])
def test_eval_forward_matches_the_reference(cell, weights, route):
    model = program.build_model(cell.config, weights, CPU).eval()
    model.set_attn_impl("composed" if route == "composed" else "kernel")
    x, _ = drive._inputs(cell.config, 4, SEED, CPU)
    ref = check.reference_model(cell, "f32", CPU).eval()
    ref.load_state_dict(weights, strict=True)
    with torch.no_grad(), K.plain_versions(route == "plain"):
        got, want = model(x), ref(x)
    assert got.shape == want.shape == (4, 32, 16, 3)
    gap = (got - want).abs().max().item()
    assert gap <= EVAL_TOL, gap


def test_flash_train_steps_follow_the_reference(cell):
    assert cell.config["model"]["attn_train_impl"] == "flash"
    out = drive.run_train(cell, SEED, 0.3, False, CPU, time.perf_counter())
    assert out.attempted > 0
    for name, tol in TOL.items():
        assert out.numbers[name] <= tol, (name, out.numbers[name])


class _TF32Operands(Numerics):
    """Float32 products whose operands are rounded to TF32's 10-bit
    mantissa, as the card's TF32 path reads them; the gradient passes the
    rounding unchanged."""

    def q(self, t):
        bits = t.detach().contiguous().view(torch.int32)
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return t + (r - t.detach())


def test_tf32_operands_break_a_tolerance(cell, weights, monkeypatch):
    tc = cell.config["train"]
    lrs = [tc["learning_rate"] * tc["lr_values"][0]] * drive.FOLLOWED
    bs, nb = cell.traffic["batch"], cell.traffic["batches"]
    ref = drive.reference_steps(cell, "f32", weights, SEED, bs, nb, lrs, CPU)
    monkeypatch.setattr(check, "Numerics", lambda mode: _TF32Operands())
    ctl = drive.reference_steps(cell, "f32", weights, SEED, bs, nb, lrs, CPU)
    got = check.train_numbers(ctl, ref)
    assert any(got[k] > TOL[k] for k in TOL), got


def _names(model, params):
    ids = {id(p) for p in params}
    return {n for n, p in model.named_parameters() if id(p) in ids}


def test_l2_takes_the_same_leaves_in_the_port_and_the_reference(cell):
    port = build_model(program.model_config(cell.config))
    ref = check.reference_model(cell, "f32", CPU)
    mine = _names(port, losses.l2_kernels(port))
    assert mine == _names(ref, ref.l2_weights())
    layers = cell.config["model"]["vit_layers"]
    assert mine == {"patch_embeddings.weight", "head.weight",
                    *(f"block_{i}.ffn.{fc}.weight" for i in range(layers)
                      for fc in ("fc1", "fc2"))}


def test_configuration_counts_the_parameters_at_full_width():
    full = _cell(json.loads(json.dumps(CONFIG)))
    with torch.device("meta"):
        port = build_model(program.model_config(CONFIG))
    ref = check.reference_model(full, "f32", "meta")
    assert set(port.state_dict()) == set(ref.state_dict())
    counts = {sum(p.numel() for p in m.parameters()) for m in (port, ref)}
    assert counts == {CONFIG["parameters"]} == {96_122_897}


def test_configuration_counts_the_products_of_a_frame():
    full = _cell(json.loads(json.dumps(CONFIG)))
    ref = check.reference_model(full, "f32", "meta")
    h, w = CONFIG["model"]["img_size"]
    x = torch.empty(1, h, w, CONFIG["model"]["in_channels"], device="meta")
    with FlopCounterMode(display=False) as fc:
        ref(x)
    assert fc.get_total_flops() == CONFIG["flops_per_frame"]

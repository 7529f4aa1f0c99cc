"""``cli.make_forward``'s copies: on the CPU the frames are wrapped and
copied as they are; on the card they cross through the closure's reused
page-locked buffer in chunks, and the answer comes back through pinned
memory, bit-equal to the pageable route.  This file imports no JAX, so the
machine with the card runs it on its own:

    python3 -m pytest --noconftest -q tests/test_torch_staging.py
"""

import dataclasses
import statistics
import threading
import time

import numpy as np
import pytest
import torch

from ultrasound_modeling_tpu_torch import cli

MIB = 1 << 20
# one frame's bytes: the TransUNet / ViT / Swin (256x80x10), the ResNeStUNet
# (256x64x6) and the MobileUNet (256x64x15) in float32, a row past the chunk
# target, and one float
ROW_BYTES = [256 * 80 * 10 * 4, 256 * 64 * 6 * 4, 256 * 64 * 15 * 4,
             17 * MIB, 4]


@pytest.fixture(autouse=True)
def counts():
    cli.reset_staging_counts()
    yield cli.STAGING
    cli.reset_staging_counts()


def _conv_model(device, seed=0):
    torch.manual_seed(seed)
    conv = torch.nn.Conv2d(10, 3, 3, padding=1).to(device)
    return lambda x: torch.softmax(conv(x.permute(0, 3, 1, 2)), 1
                                   ).permute(0, 2, 3, 1)


def _frames(b, seed=0, h=256, w=80, c=10):
    return np.random.default_rng(seed).standard_normal(
        (b, h, w, c)).astype(np.float32)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_bytes", ROW_BYTES)
def test_chunk_plan_covers_every_row_once(row_bytes):
    """Every batch of 1-130 rows: the chunks cover each row once, in order,
    each at most the target's bytes (or one row, where a row is larger),
    and a batch within the target is one chunk."""
    for rows in range(1, 131):
        plan = cli.chunk_rows(rows, row_bytes)
        covered = [r for a, b in plan for r in range(a, b)]
        assert covered == list(range(rows)), (rows, plan)
        assert all(b > a for a, b in plan)
        limit = max(cli.STAGE_CHUNK_BYTES, row_bytes)
        assert all((b - a) * row_bytes <= limit for a, b in plan)
        if rows * row_bytes <= cli.STAGE_CHUNK_BYTES:
            assert plan == [(0, rows)]


@pytest.mark.parametrize("rows,row_bytes,chunks", [
    (1, ROW_BYTES[0], 1), (20, ROW_BYTES[0], 1), (21, ROW_BYTES[0], 2),
    (64, ROW_BYTES[0], 4), (64, ROW_BYTES[1], 2), (256, ROW_BYTES[2], 16),
    (3, 17 * MIB, 3), (0, ROW_BYTES[0], 0)])
def test_chunk_count_follows_the_batchs_bytes(rows, row_bytes, chunks):
    assert len(cli.chunk_rows(rows, row_bytes)) == chunks


@pytest.mark.parametrize("layout", ["f32", "f64", "strided"])
def test_cpu_device_takes_the_plain_path(layout, counts, monkeypatch):
    """On the CPU the closure answers as the model does on the float32
    frames, counts ``plain`` and asks for no page-locked memory."""
    pinned = []
    for name in ("empty", "empty_like", "zeros"):
        real = getattr(torch, name)

        def spy(*a, _real=real, **k):
            if k.get("pin_memory"):
                pinned.append(k)
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, spy)
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda *_: pinned.append("Tensor.pin_memory"))
    model = _conv_model("cpu")
    x32 = _frames(3, h=16, w=8)
    x = {"f32": x32, "f64": x32.astype(np.float64),
         "strided": np.stack([x32, x32], -1)[..., 0]}[layout]
    fwd = cli.make_forward(model, torch.device("cpu"))
    with torch.inference_mode():
        want = model(torch.from_numpy(x32)).numpy()
    for _ in range(2):
        got = fwd(x)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    assert counts == {"staged": 0, "grown": 0, "plain": 2}
    assert pinned == []


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pageable(model, x, device):
    """The route make_forward took before staging: a pageable copy in, a
    pageable copy out."""
    with torch.inference_mode():
        return model(torch.from_numpy(x).to(device)).float().cpu().numpy()


_FAMILIES = {}


def _family_forward(family, dtype, device):
    """The family's full-width default model, seeded random weights, as
    the ``x -> probs`` on tensors that ``cli._make_forward`` gives."""
    key = (family, dtype)
    if key not in _FAMILIES:
        from ultrasound_modeling_tpu_torch.config import default_config
        from ultrasound_modeling_tpu_torch.models.common import full_f32_matmuls
        from ultrasound_modeling_tpu_torch.models.registry import build_model
        from ultrasound_modeling_tpu_torch.utils.checkpoint import (
            from_flax, random_flax_variables)
        full_f32_matmuls()
        mcfg = dataclasses.replace(default_config(family).model,
                                   compute_dtype=dtype)
        model = build_model(mcfg)
        model.load_state_dict(from_flax(random_flax_variables(model, 0),
                                        family), strict=True)
        model = model.to(device).eval()
        _FAMILIES.clear()
        _FAMILIES[key] = lambda x: model(x).float()
    return _FAMILIES[key]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5, 64])
@pytest.mark.parametrize("family,dtype,repeats", [
    ("transunet", "bfloat16", True), ("swin", "float32", False)])
def test_staged_answers_are_bit_equal_to_the_pageable_route(
        cuda, counts, family, dtype, repeats, batch):
    """The staged route hands the forward the very frames the pageable copy
    gives and returns its very output.  Where the family's forward repeats
    bit for bit (the bf16 TransUNet) the whole answer equals the pageable
    route's; the f32 Swin's forward differs from call to call in the last
    bits (printed), so there the route is held at both of its ends."""
    forward = _family_forward(family, dtype, cuda)
    seen = {}

    def model(x):
        seen["x"] = x.clone()
        seen["probs"] = forward(x)
        return seen["probs"]

    x = _frames(batch, seed=batch)
    want = _pageable(forward, x, cuda)
    again = _pageable(forward, x, cuda)
    print(f"{family} b{batch}: two pageable answers differ by at most "
          f"{np.abs(want - again).max():.3g}")
    got = cli.make_forward(model, cuda)(x)
    assert got.shape == (batch, 256, 80, 3) and got.dtype == np.float32
    assert torch.equal(seen["x"], torch.from_numpy(x).to(cuda))
    assert np.array_equal(got, seen["probs"].cpu().numpy())
    if repeats:
        assert np.array_equal(again, want)
        assert np.array_equal(got, want)
    assert counts == {"staged": 1, "grown": 1, "plain": 0}


@pytest.mark.cuda
def test_an_answer_survives_the_next_call(cuda):
    """The caller owns each answer: a second call on other frames leaves
    the first as it was, in memory of its own."""
    model = _conv_model(cuda)
    fwd = cli.make_forward(model, cuda)
    x1, x2 = _frames(64, 1), _frames(64, 2)
    first = fwd(x1)
    kept = first.copy()
    second = fwd(x2)
    assert np.array_equal(first, kept)
    assert np.array_equal(first, _pageable(model, x1, cuda))
    assert np.array_equal(second, _pageable(model, x2, cuda))
    assert not np.shares_memory(first, second)


@pytest.mark.cuda
def test_staging_grows_for_a_larger_batch_only(cuda, counts):
    model = _conv_model(cuda)
    fwd = cli.make_forward(model, cuda)
    seen = []
    for k, b in enumerate([8, 8, 8, 16, 4, 8, 16, 1]):
        x = _frames(b, k)
        assert np.array_equal(fwd(x), _pageable(model, x, cuda))
        seen.append(counts["grown"])
    assert seen == [1, 1, 1, 2, 2, 2, 2, 2]
    assert counts == {"staged": 8, "grown": 2, "plain": 0}


@pytest.mark.cuda
def test_a_forward_that_raises_leaves_the_next_call_correct(cuda, counts):
    """A forward that fails after its first kernels were queued (the frames
    already staged and their copies in flight): the next call, on other
    frames, answers right."""
    conv = _conv_model(cuda)
    fail = [True]

    def model(x):
        y = conv(x)
        if fail[0]:
            fail[0] = False
            raise RuntimeError("forward failed")
        return y

    fwd = cli.make_forward(model, cuda)
    with pytest.raises(RuntimeError, match="forward failed"):
        fwd(_frames(64, 1))
    x = _frames(64, 2)
    assert np.array_equal(fwd(x), _pageable(conv, x, cuda))
    assert counts == {"staged": 2, "grown": 1, "plain": 0}


@pytest.mark.cuda
def test_threads_calling_one_closure_get_their_own_answers(cuda, counts):
    """Six threads call one closure at once, on batches of their own sizes
    and frames: every answer is its frames' (the buffer is never written
    while another call's copy reads it)."""
    model = _conv_model(cuda)
    fwd = cli.make_forward(model, cuda)
    xs = {k: _frames(4 + 6 * k, 10 + k) for k in range(6)}
    want = {k: _pageable(model, x, cuda) for k, x in xs.items()}
    bad, n = [], 5

    def work(k):
        for _ in range(n):
            if not np.array_equal(fwd(xs[k]), want[k]):
                bad.append(k)

    threads = [threading.Thread(target=work, args=(k,)) for k in xs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert counts["staged"] == len(xs) * n and counts["plain"] == 0


def _median_ms(fn, reps, pool):
    out = []
    for i in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        fn(pool[i % len(pool)])
        out.append((time.perf_counter_ns() - t) / 1e6)
    return statistics.median(out)


@pytest.mark.cuda
def test_copy_rates_on_the_card_host(cuda, monkeypatch):
    """GB/s of each copy of a 52.4 MB b64 batch (256x80x10 float32) from a
    pool of 8 batches (past the host's caches, as the benchmark's pool):
    pageable H2D, the host's copy into pinned memory, pinned H2D, the
    staged H2D (host return, and to the end of its DMA) at chunk targets of
    1-64 MiB, pinned and pageable D2H of the 15.7 MB answer; medians of 24
    copies.  Each copy lands bit-equal."""
    pool = [_frames(64, k) for k in range(8)]
    nbytes = pool[0].nbytes
    pinned = torch.empty(pool[0].shape, pin_memory=True)
    dev = torch.empty(pool[0].shape, device=cuda)
    reps = 24

    def gbps(ms, n=nbytes):
        return n / ms / 1e6

    def pageable_h2d(x):
        torch.from_numpy(x).to(cuda)
        torch.cuda.synchronize()

    rates = {"pageable_h2d": gbps(_median_ms(pageable_h2d, reps, pool))}
    rates["host_to_pinned"] = gbps(_median_ms(
        lambda x: pinned.copy_(torch.from_numpy(x)), reps, pool))

    def pinned_h2d(_):
        dev.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize()
    rates["pinned_h2d"] = gbps(_median_ms(pinned_h2d, reps, pool))
    assert torch.equal(dev.cpu(), pinned)

    for chunk_mib in (1, 2, 4, 8, 16, 64):
        monkeypatch.setattr(cli, "STAGE_CHUNK_BYTES", chunk_mib * MIB)
        staging = cli._Staging(cuda)
        with torch.inference_mode():
            staging.to_device(pool[0])
            host = _median_ms(staging.to_device, reps, pool)

            def whole(x):
                staging.to_device(x)
                torch.cuda.synchronize()
            done = _median_ms(whole, reps, pool)
            assert torch.equal(staging.to_device(pool[3]).cpu(),
                               torch.from_numpy(pool[3]))
        rates[f"staged_h2d_{chunk_mib}mib_host"] = gbps(host)
        rates[f"staged_h2d_{chunk_mib}mib_done"] = gbps(done)

    probs = torch.rand(64, 256, 80, 3, device=cuda)
    out_bytes = probs.numel() * 4
    staging = cli._Staging(cuda)
    with torch.inference_mode():
        rates["pinned_d2h"] = gbps(_median_ms(
            lambda _: staging.to_host(probs), reps, pool), out_bytes)
    rates["pageable_d2h"] = gbps(_median_ms(
        lambda _: probs.cpu(), reps, pool), out_bytes)
    name = torch.cuda.get_device_name(0)
    print(f"copy GB/s on {name}, torch threads {torch.get_num_threads()}: "
          + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()))
    assert all(v > 0 for v in rates.values())

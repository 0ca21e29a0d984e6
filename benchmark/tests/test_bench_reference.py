"""The frozen plain reference (``benchmark/reference/``) against the port's
plain path on the CPU at a tiny width, on the benchmark's seeded weights:
the rollout, the posterior, the video discriminator, the losses, three train
steps through the port's ``MultiStep``, and the metrics. Also: the reference
imports nothing of the program and nothing of JAX; its train steps in
sample blocks equal those of the whole batch; it takes a bf16
configuration and refuses the dtypes it does not know; and, called through
``benchmark/models/savp.py``, it gives at the rehearsal's sizes the very
bits it gave before it was found by the model's name."""

import ast
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import common, models, program, rehearse
from benchmark.kinds import train as train_kind
from benchmark.reference import metrics as refm
from benchmark.reference import savp as ref

TINY = {"ngf": 4, "nef": 8, "ndf": 4, "nz": 4, "clip_length": 3, "sequence_length": 5}
REFERENCE_DIR = Path(__file__).resolve().parents[1] / "reference"
NOT_IMPORTED = set(common.FORBIDDEN) | {"video_prediction_torch", "benchmark"}


@pytest.mark.parametrize("path", sorted(REFERENCE_DIR.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path.name}: relative import"
            names.add(node.module.split(".", 1)[0])
    assert not names & NOT_IMPORTED, names & NOT_IMPORTED


@pytest.fixture(scope="module")
def built():
    torch.manual_seed(0)
    cfg = common.load_json(common.ROOT / "benchmark" / "configs" / "savp_bair64.json")
    hp = program.hparams(cfg, TINY)
    model, weights = program.build_model(cfg, hp, (32, 32, 3), 2024, "cpu")
    ref.check_supported(hp.to_dict())
    return cfg, hp, model, weights


def _clips(n, t, seed=3):
    return torch.from_numpy(common.make_clips(n, t, 32, 32, 3, torch.Generator().manual_seed(seed), "cpu"))


def test_eval_rollout(built):
    _, hp, model, weights = built
    images = _clips(3, hp.sequence_length)
    zs = torch.randn(3, hp.sequence_length - 1, hp.nz, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model({"images": images}, train=False, zs_prior=zs)["gen_images"]
        want = ref.eval_rollout(weights, hp.to_dict(), images.float() / 255.0, zs)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)


def test_posterior_and_discriminator(built):
    _, hp, model, weights = built
    images = _clips(2, hp.sequence_length).float() / 255.0
    with torch.no_grad():
        for got, want in zip(model.posterior(images), ref.posterior(weights, images)):
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
        us = {k: v for k, v in weights.items() if k.endswith(".u")}
        logits, feats, new_u = model.discriminator["video"](images[:, : hp.clip_length])
        r_w, r_u = ref.normalized_weights(weights, us, "video")
        r_logits, r_feats = ref.apply_discriminator(weights, r_w, "video", images[:, : hp.clip_length])
    torch.testing.assert_close(logits, r_logits, atol=1e-6, rtol=1e-5)
    for a, b in zip(feats, r_feats):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    for k in new_u:
        torch.testing.assert_close(new_u[k], r_u[k], atol=1e-6, rtol=1e-5)


def test_losses(built):
    _, hp, model, weights = built
    images = _clips(2, hp.sequence_length)
    noise = train_kind.draw_noise(hp, 2, hp.sequence_length, torch.Generator().manual_seed(4), "cpu")
    total, aux = model.compute_losses({"images": images}, 0, noise=noise)
    params = {k: v for k, v in weights.items() if not k.endswith(".u")}
    us = {k: v for k, v in weights.items() if k.endswith(".u")}
    r_total, r_g, r_d, _, _ = ref.train_losses(params, us, hp.to_dict(), images, noise, 0)
    for got, want in ((total, r_total), (aux["g_loss"], r_g), (aux["d_loss"], r_d)):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def test_train_steps_through_multistep():
    """The harness's train cell at a tiny size: the port's ``MultiStep`` on
    the CPU against the reference's steps, leaf by leaf."""
    from benchmark import rehearse

    out = rehearse.rehearse("savp_bair64.train_b16_k4")
    c = out["cell"]
    got, want = c.outputs, out["want"]
    np.testing.assert_allclose(np.array(got["losses"]), np.array(want["losses"]), rtol=1e-5)
    med = float(np.median(list(want["grad_norms"].values())))
    for k, g in want["grad_norms"].items():
        assert abs(got["grad_norms"][k] - g) <= 1e-4 * max(g, med), k
    assert set(got["change_norms"]) == set(want["change_norms"])
    torch.testing.assert_close(got["first_frames"], want["first_frames"], atol=2e-6, rtol=1e-5)


def test_metrics_against_the_ports():
    from video_prediction_torch import metrics as M
    from video_prediction_torch.models.vgg import VGGMetric

    gen = torch.Generator().manual_seed(5)
    a, b = torch.rand(2, 3, 32, 32, 3, generator=gen), torch.rand(2, 3, 32, 32, 3, generator=gen)
    torch.testing.assert_close(M.peak_signal_to_noise_ratio(a, b), refm.psnr(a, b), atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(M.structural_similarity(a, b), refm.ssim(a, b), atol=1e-6, rtol=1e-5)
    vgg, weights = program.vgg_metric(9, "cpu")
    assert isinstance(vgg, VGGMetric)
    torch.testing.assert_close(vgg(a, b), refm.vgg_cosine(weights, a, b), atol=1e-5, rtol=1e-5)
    chunks = [{"psnr": torch.rand(2, 3, 4, generator=gen)} for _ in range(3)]
    red = refm.best_and_mean(chunks)
    allv = torch.cat([c["psnr"] for c in chunks], dim=1)
    torch.testing.assert_close(red["psnr_max"], allv.max(1).values)
    torch.testing.assert_close(red["psnr_avg"], allv.mean(1))


@pytest.fixture(scope="module")
def steps_of_eight(built):
    """Three reference train steps at batch 8 from the seeded weights, as
    one block (the whole batch's objective, one backward pass)."""
    _, hp, _, weights = built
    b, k, t = 8, 3, hp.sequence_length
    clips = _clips(b * k, t).reshape(k, b, t, 32, 32, 3)
    gen = torch.Generator().manual_seed(4)
    noises = [train_kind.draw_noise(hp, b, t, gen, "cpu") for _ in range(k)]
    params = {n: v for n, v in weights.items() if not n.endswith(".u")}
    us = {n: v for n, v in weights.items() if n.endswith(".u")}
    args = (params, us, hp.to_dict(), list(clips), noises)
    return args, ref.train_steps(*args, block=b)


@pytest.mark.parametrize("block", [2, 3])
def test_blocked_train_steps_equal_one_block(steps_of_eight, block):
    """Blocks of 2 (and of 3: an uneven last block) against one block of 8:
    each step's losses, each leaf's first gradient and change, the first
    frames and the ``u`` vectors after each step, within fp32 round-off. The
    order of the sums differs, so the gradients differ by ~1e-7; Adam turns
    that into more only where a leaf's gradient has elements near its
    epsilon (``tiny_grad_share``), where its update is no longer near the
    gradient's sign."""
    args, whole = steps_of_eight
    got = ref.train_steps(*args, block=block)
    np.testing.assert_allclose(np.array(got["losses"]), np.array(whole["losses"]), rtol=1e-6)
    torch.testing.assert_close(got["first_frames"], whole["first_frames"], atol=1e-6, rtol=0)
    for u_got, u_whole in zip(got["u_by_step"], whole["u_by_step"], strict=True):
        for name, u in u_whole.items():
            torch.testing.assert_close(u_got[name], u, atol=1e-6, rtol=0)
    gaps = train_kind.Cell.leaf_gaps(got, whole)
    assert max(gaps["grad"].values()) <= 1e-5
    assert set(gaps["change"]) == {n for n, g in whole["grad_norms"].items()
                                   if g >= 1e-3 * np.median(list(whole["grad_norms"].values()))}
    for name, gap in gaps["change"].items():
        assert gap <= (1e-2 if whole["tiny_grad_share"][name] >= 0.01 else 1e-4), (name, gap)


def test_blocks_take_shares_of_the_whole_batch(steps_of_eight):
    """A mean over a block, not over the batch, would weigh each block's
    samples as a whole batch: the blocked losses would read four times the
    whole batch's."""
    args, whole = steps_of_eight
    params, us, hp, clips, noises = args
    W = {key: ref.normalized_weights(params, us, key)[0] for key in ref.DISCRIMINATORS}
    g_losses = [ref.block_losses(params, W, hp, clips[0][lo : lo + 2], ref.noise_rows(noises[0], slice(lo, lo + 2)),
                                 0, 8)[1] for lo in range(0, 8, 2)]
    assert float(sum(g_losses)) == pytest.approx(whole["losses"][0][0], rel=1e-6)


@pytest.mark.parametrize("dtypes,ok", [(("float32", "float32"), True), (("bfloat16", "bfloat16"), True),
                                       (("bfloat16", "float32"), True), (("float16", "float32"), False),
                                       (("float32", "float16"), False)])
def test_supported_dtypes(built, dtypes, ok):
    hp = dict(built[1].to_dict(), compute_dtype=dtypes[0], gate_dtype=dtypes[1])
    if ok:
        ref.check_supported(hp)
    else:
        with pytest.raises(ValueError):
            ref.check_supported(hp)


# the reference's outputs below, at one CPU thread (more threads sum the
# gradients in another order), before SAVP's parts were found by the model's
# name: the losses, and SHA-256 digests of every output
FROZEN = {"train_losses": [[12.588494300842285, 0.20043425261974335], [8.735883712768555, 0.19912970066070557]],
          "train_steps": "e16d0db017a4378ff9763625570649a30605a154511bdeb15a32a65275882fe0",
          "eval_rollout": "dc2320e67212b6b1745dab8e5c97c8977a9f2fb0e7a82a7253a209cbcd7aac60"}


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.detach().contiguous().cpu().numpy().tobytes() if torch.is_tensor(p)
                 else json.dumps(p, sort_keys=True).encode())
    return h.hexdigest()


def test_savp_reference_gives_the_same_bits():
    """Two train steps and a prior rollout at the rehearsal's sizes, through
    the model's parts (``models.find``), from the seeded weights and clips."""
    cfg = common.load_json(common.ROOT / "benchmark" / "configs" / "savp_bair64.json")
    parts = models.find(cfg)
    hp = program.hparams(cfg, dict(rehearse.TINY, **rehearse.TINY_SEQUENCE["train"], **rehearse.PLAIN, batch_size=2))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, weights = program.build_model(cfg, hp, (32, 32, 3), 2**31 + 11, "cpu")
        k, b, t = 2, 2, hp.sequence_length
        clips = common.make_clips(k * b, t, 32, 32, 3, common.generator(5, 1, "cpu"), "cpu")
        gen = common.generator(5, 2, "cpu")
        noises = [train_kind.draw_noise(hp, b, t, gen, "cpu") for _ in range(k)]
        batches = [{"images": v} for v in torch.from_numpy(clips).reshape(k, b, t, 32, 32, 3)]
        r = parts.train_steps(weights, hp.to_dict(), batches, noises)
        zs = torch.randn((3, t - 1, hp.nz), generator=common.generator(5, 3, "cpu"))
        images = common.make_clips(3, t, 32, 32, 3, common.generator(5, 4, "cpu"), "cpu")
        with torch.no_grad():
            frames = parts.eval_rollout(weights, hp.to_dict(), {"images": torch.from_numpy(images).float() / 255.0}, zs)
    finally:
        torch.set_num_threads(threads)
    assert [list(s) for s in r["losses"]] == FROZEN["train_losses"]
    assert _digest(r["losses"], r["grad_norms"], r["tiny_grad_share"], r["change_norms"], r["first_frames"],
                   *[u[n] for u in r["u_by_step"] for n in sorted(u)]) == FROZEN["train_steps"]
    assert _digest(frames) == FROZEN["eval_rollout"]

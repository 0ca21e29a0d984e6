"""Actions and states from the seed: a configuration that states an
``action_dim`` or a ``state_dim`` gets a model built at those dims and clips
that carry seeded ``actions`` and ``states`` under the port's loaders' keys,
which the port's train step takes; one that states none gets the very clips,
weights and batches it got before conditioning inputs existed."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import common, program, rehearse
from benchmark.kinds import train as train_kind

TINY_SNA = {"ngf": 4, "context_frames": 2, "sequence_length": 5, "batch_size": 2}
SHAPE = (32, 32, 3)
SEED = 2**31 + 11
# SHA-256 of ``make_clips(6, 5, 32, 32, 3)`` from SEED's clip stream, and of the
# rehearsal's savp_bair64 weights from SEED, before conditioning inputs existed
CLIPS_DIGEST = "14c577edfaf2b31513d259136a6d316e86b223e8aed45406335847faff1c27cc"
WEIGHTS_DIGEST = "4d371b5c1caab0cf7326b27bc5e452a20b4965fc75e44c37bcf7c11e4b83f506"


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def test_no_dims_change_no_bit():
    cfg = common.load_json(common.BENCH_DIR / "configs" / "savp_bair64.json")
    assert "action_dim" not in cfg and "state_dim" not in cfg
    pool = common.make_inputs(6, 5, SHAPE, cfg, SEED, "cpu")
    assert set(pool) == {"images"} and _digest(torch.from_numpy(pool["images"])) == CLIPS_DIGEST
    batch = next(program.host_batches(pool, 2))
    assert set(batch) == {"images"} and np.array_equal(batch["images"], pool["images"][:2])
    hp = program.hparams(cfg, dict(rehearse.TINY, **rehearse.TINY_SEQUENCE["train"], **rehearse.PLAIN, batch_size=2))
    model, weights = program.build_model(cfg, hp, SHAPE, SEED, "cpu")
    assert (model.generator.cell.action_dim, model.generator.cell.state_dim) == (0, 0)
    assert _digest(*[weights[k] for k in sorted(weights)]) == WEIGHTS_DIGEST


@pytest.fixture
def sna(sna_l2):
    cfg = sna_l2[1]
    hp = program.hparams(cfg, TINY_SNA)
    model, _ = program.build_model(cfg, hp, SHAPE, 7, "cpu")
    return cfg, hp, model


def test_sna_builds_at_its_dims(sna):
    cfg, hp, model = sna
    assert (cfg["action_dim"], cfg["state_dim"]) == (4, 3) and hp.use_states and hp.nz == 0
    assert (model.generator.cell.action_dim, model.generator.cell.state_dim) == (4, 3)


def test_sna_clips_carry_seeded_actions_and_states(sna):
    cfg = sna[0]
    pool = common.make_inputs(8, 5, SHAPE, cfg, SEED, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in pool.items()} == {
        "images": ((8, 5, *SHAPE), np.uint8), "actions": ((8, 5, 4), np.float32), "states": ((8, 5, 3), np.float32)}
    again, other = common.make_inputs(8, 5, SHAPE, cfg, SEED, "cpu"), common.make_inputs(8, 5, SHAPE, cfg, 3, "cpu")
    assert all(np.array_equal(pool[k], again[k]) for k in pool)
    assert not np.array_equal(pool["actions"], other["actions"]) and not np.array_equal(pool["states"], other["states"])
    plain = common.make_inputs(8, 5, SHAPE, dict(cfg, action_dim=0, state_dim=0), SEED, "cpu")
    assert set(plain) == {"images"} and np.array_equal(plain["images"], pool["images"])
    assert np.abs(pool["actions"]).max() <= 1.0 and len(np.unique(pool["actions"])) == pool["actions"].size
    batches = program.host_batches(pool, 2)
    next(batches)
    batch = next(batches)
    assert all(np.array_equal(batch[k], pool[k][2:4]) for k in pool)


def test_sna_train_step_takes_them(sna):
    """Two steps through the train kind's own pieces on the CPU: the host
    batches, ``DeviceFeeder(stack=2)``, ``make_train_step(model, 2)`` (a
    ``MultiStep``) and the benchmark's noise. The states reach the state
    loss; the actions move the rollout."""
    from video_prediction_torch.data import DeviceFeeder
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_train_step

    cfg, hp, model = sna
    pool = common.make_inputs(4, hp.sequence_length, SHAPE, cfg, SEED, "cpu")
    with torch.no_grad():
        batch = {k: torch.from_numpy(v[:2]) for k, v in pool.items()}
        moved = dict(batch, actions=batch["actions"] + 0.5)
        assert not torch.equal(model(batch)["gen_images"], model(moved)["gen_images"])
    opt_g, opt_d = make_optimizers(model, 2)
    ts = TrainState(model, opt_g, opt_d, 0, common.generator(SEED, 3, "cpu"))
    step = make_train_step(model, steps_per_call=2)
    gen = common.generator(SEED, 2, "cpu")
    noises = [train_kind.draw_noise(hp, 2, hp.sequence_length, gen, "cpu") for _ in range(2)]
    feeder = DeviceFeeder(program.host_batches(pool, 2), "cpu", stack=2)
    try:
        batches = next(feeder)
        assert {k: tuple(v.shape[:2]) for k, v in batches.items()} == {"images": (2, 2), "actions": (2, 2),
                                                                        "states": (2, 2)}
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step(ts, batches, noises)
    finally:
        feeder.close()
    scalars = dict(zip(step.keys, step.scalars_by_step[-1].tolist()))
    assert np.isfinite(scalars["g_loss"]) and scalars["g/state"] > 0
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())

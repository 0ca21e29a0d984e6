"""``benchmark/counts.py`` and SAVP's counts (``benchmark/models/savp.py``):
the conv and GEMM FLOPs against ``torch.utils.flop_counter.FlopCounterMode``
on the port's modules at a small size; the K1-K3 bytes against the port's
``kernels/roofline.py`` at the shapes and dtypes of every cell, on the rows
of the K2 calls that one step of the port's generator makes at the cell's
image shape, and on the kernel table's bf16 rows; the counts of the fp32
cells as they were before K2 was counted at its dtype; and each cell's unit
(FLOPs, K1-K3 bytes and device events) as counted before the model's counts
moved out of ``counts.py``."""

import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, counts, faults, models, program, rehearse, run
from benchmark.models import savp
from video_prediction_torch.kernels import roofline

SPEC = common.benchmark_spec()
SMALL = {"ngf": 8, "nef": 16, "ndf": 8, "nz": 4}


def _counted(fn, *args) -> int:
    with FlopCounterMode(display=False) as mode:
        fn(*args)
    return mode.get_total_flops()


@pytest.fixture(scope="module")
def small():
    cfg = common.load_json(common.ROOT / "benchmark" / "configs" / "savp_bair64.json")
    hp = program.hparams(cfg, dict(SMALL, sequence_length=4))
    model, _ = program.build_model(cfg, hp, (32, 32, 3), 7, "cpu")
    return hp, model


def test_generator_flops(small):
    hp, model = small
    b, t, h, w, c = 2, 4, 32, 32, 3
    images = torch.rand(b, t, h, w, c)
    use_gt = torch.ones(t - 1, b, dtype=torch.bool)
    zs = torch.randn(b, t - 1, hp.nz)
    with torch.no_grad():
        got = _counted(model.generator, images, use_gt, zs)
    # the plain compositing (K3's CPU version) is an einsum, which the counter
    # sees: 2 x K candidates x C a pixel, not model FLOPs
    k3 = 2 * b * (t - 1) * h * w * savp.n_candidates(hp.to_dict()) * c
    assert got - k3 == savp.rollout_flops(hp.to_dict(), b, t, h, w, c)


def test_posterior_and_discriminator_flops(small):
    hp, model = small
    b, t, h, w, c = 2, 4, 32, 32, 3
    images = torch.rand(b, t, h, w, c)
    with torch.no_grad():
        assert _counted(model.posterior, images) == savp.posterior_flops(hp.to_dict(), b * (t - 1), h, w, c)
        clip = min(hp.clip_length, t - 1)
        got = _counted(model.discriminator["video"], images[:, :clip])
        # the power iterations' products are no model FLOPs
        power = sum(_counted(m.normalized_weight) for m in model.discriminator["video"].modules() if hasattr(m, "u"))
    assert got - power == savp.video_disc_flops(hp.to_dict(), b, clip, h, w, c)


def test_vgg_flops():
    from video_prediction_torch.models.vgg import VGG16Features

    with torch.no_grad():
        assert _counted(VGG16Features(), torch.rand(2, 32, 32, 3)) == counts.vgg_flops(2, 32, 32)


def test_train_step_is_three_forwards(small):
    hp = small[0].to_dict()
    b, t, h, w, c = 2, 4, 32, 32, 3
    forward = (savp.rollout_flops(hp, 2 * b, t, h, w, c) + savp.posterior_flops(hp, b * (t - 1), h, w, c)
               + 2 * savp.video_disc_flops(hp, 3 * b, min(hp["clip_length"], t - 1), h, w, c))
    assert savp.train_step_flops(hp, b, t, h, w, c) == 3 * forward


def unit_batch(traffic) -> int:
    """The samples of one K1-K3 launch in a cell of ``traffic``."""
    return {"train": 2 * traffic.get("batch_size", 0),
            "generate": traffic.get("clips_per_request", 0) * traffic.get("samples_per_clip", 0),
            "evaluate": traffic.get("batch_size", 0) * traffic.get("samples_per_rollout", 0)}[traffic["kind"]]


_STEP_CALLS = {}


def port_step_calls(cfg):
    """One step of the port's generator, on the CPU in fp32 at batch 1, at
    the configuration's widths and image shape: the ``(R, C)`` of each K2
    call, and the number of K1 and of K3 calls."""
    if cfg["name"] not in _STEP_CALLS:
        from video_prediction_torch.models import savp as port_savp
        from video_prediction_torch.ops import rnn

        hp = program.hparams(cfg, dict(rehearse.PLAIN, sequence_length=2))
        model, _ = program.build_model(cfg, hp, cfg["image_shape"], 7, "cpu")
        calls = {"K1": 0, "K2": [], "K3": 0}

        def spy(owner, name, record):
            def make(original):
                def call(*args, **kwargs):
                    record(*args)
                    return original(*args, **kwargs)

                return call

            return faults.patched(owner, name, make)

        def count(group):
            def record(*args):
                calls[group] += 1

            return record

        with spy(rnn, "fused_ln_gate", lambda z, c, *rest: calls["K2"].append(tuple(c.shape))), \
                spy(port_savp, "apply_cdna_kernels", count("K1")), spy(port_savp, "composite", count("K3")), \
                torch.no_grad():
            images = torch.rand(1, 2, *cfg["image_shape"])
            model.generator(images, torch.ones(1, 1, dtype=torch.bool), torch.zeros(1, 1, hp.nz))
        _STEP_CALLS[cfg["name"]] = calls
    return _STEP_CALLS[cfg["name"]]


def assert_counts_are_the_ports(cfg, batch):
    """The model's K1-K3 bytes of a generator step at ``batch``, forward and
    backward, are the port's roofline formulas on the port's own calls, and
    its events are those calls."""
    parts = models.find(cfg)
    hp = cfg["hparams"]
    h, w, c = cfg["image_shape"]
    k = savp.n_candidates(hp)
    # K2 takes bf16 rows under bf16 gates or bf16 compute (ops/rnn.py); K1 and K3 fp32 images and logits
    k2 = 2 if "bfloat16" in (hp["gate_dtype"], hp["compute_dtype"]) else 4
    calls = port_step_calls(cfg)
    rows = [(batch * r, f) for r, f in calls["K2"]]
    fwd = parts.kernel_bytes(hp, batch, h, w, c, False)
    assert fwd["K1"] == roofline.cdna_forward(batch, h, w, c)[0]
    assert fwd["K2"] == roofline.ln_gate_forward(rows, itemsize=k2)[0]
    assert fwd["K3"] == roofline.composite_forward(batch, k, h, w, c)[0]
    bwd = parts.kernel_bytes(hp, batch, h, w, c, True)
    assert bwd["K1"] == roofline.cdna_backward(batch, h, w, c)[0]
    assert bwd["K2"] == roofline.ln_gate_backward(rows, itemsize=k2)[0]
    assert bwd["K3"] == roofline.composite_backward(batch, k, h, w, c)[0]
    assert parts.kernel_events(hp, h, w, False) == {"K1": calls["K1"], "K2": len(rows), "K3": calls["K3"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_kernel_bytes_match_the_ports_roofline(cell):
    _, cfg, traffic = common.resolve(SPEC, cell)
    assert_counts_are_the_ports(cfg, unit_batch(traffic))


def test_counts_follow_the_port_at_128_px(kth128):
    """At 128 px the generator has four scales, not three: eight ConvLSTMs,
    the bottleneck's at C = 512 on 8 x 8."""
    cfg = kth128[1]
    assert_counts_are_the_ports(cfg, 2 * cfg["hparams"]["batch_size"])
    assert len(port_step_calls(cfg)["K2"]) == 8 and (64, 512) in port_step_calls(cfg)["K2"]


@pytest.mark.parametrize("backward,batch,megabytes", [(False, 64, 308.31), (False, 128, 616.59), (True, 128, 1057.02)])
def test_k2_bf16_bytes_are_the_kernel_tables(backward, batch, megabytes):
    """The kernel table's K2 bf16 rows (``PERF.md``), from the port's
    ``kernels/roofline.py`` with its bf16 itemsize."""
    cfg = common.load_json(common.ROOT / "benchmark" / "configs" / "savp_bair64_bf16.json")
    hp = cfg["hparams"]
    got = savp.kernel_bytes(hp, batch, *cfg["image_shape"], backward)["K2"]
    ports = (roofline.ln_gate_backward if backward else roofline.ln_gate_forward)(roofline.ln_gate_step(batch),
                                                                                   itemsize=2)[0]
    assert got == ports and round(got / 1e6, 2) == megabytes


# each fp32 cell's launch batch, K1-K3 bytes of a generator step forward and
# backward, and FLOPs of a unit, as counted before K2 was counted at its dtype
FP32_COUNTS = {
    "savp_bair64.train_b16_k4": (32, (7877120, 308308224, 16252928), (9462784, 528536064, 30932992),
                                 15998384013312),
    "savp_kth64.eval_long_b8_n100": (64, (15754240, 616589568, 32505856), (18925568, 1057018368, 61865984),
                                     500903452807680),
    "savp_bair64.generate_b8x8": (64, (15754240, 616589568, 32505856), (18925568, 1057018368, 61865984),
                                  9926272221184),
    "savp_kth64.train_b16_k4": (32, (7877120, 308308224, 16252928), (9462784, 528536064, 30932992), 26883419209728),
}


@pytest.mark.parametrize("cell", sorted(FP32_COUNTS))
def test_fp32_cells_count_as_before(cell):
    _, cfg, traffic = common.resolve(SPEC, cell)
    hp, (h, w, c), t = cfg["hparams"], cfg["image_shape"], cfg["hparams"]["sequence_length"]
    batch, fwd, bwd, flops = FP32_COUNTS[cell]
    assert unit_batch(traffic) == batch
    assert tuple(savp.kernel_bytes(hp, batch, h, w, c, False).values()) == fwd
    assert tuple(savp.kernel_bytes(hp, batch, h, w, c, True).values()) == bwd
    long_t = cfg["long_sequence_length"]
    unit = {"train": lambda: savp.train_step_flops(hp, traffic["batch_size"], t, h, w, c),
            "generate": lambda: savp.rollout_flops(hp, batch, t, h, w, c),
            "evaluate": lambda: (savp.rollout_flops(hp, traffic["batch_size"] * traffic["num_samples"], long_t, h, w, c)
                                 + counts.metrics_flops(traffic["batch_size"], traffic["num_samples"],
                                                        long_t - hp["context_frames"], h, w, c, traffic["metrics"]))}
    assert unit[traffic["kind"]]() == flops


# each cell's unit as its kind counts it (``flops_per_unit``, ``kernel_work``):
# FLOPs, K1-K3 bytes and K1-K3 device events, as counted before each model's
# counts moved into ``benchmark/models/<model>.py``
UNITS = {
    "savp_bair64.train_b16_k4": (63993536053248, (1109549056, 50386710528, 2791309312), (176, 1056, 132)),
    "savp_kth64.eval_long_b8_n100": (500903452807680, (7987399680, 312610910976, 16480468992), (507, 3042, 507)),
    "savp_bair64.generate_b8x8": (9926272221184, (173296640, 6782485248, 357564416), (11, 66, 11)),
    "savp_kth64.train_b16_k4": (107533676838912, (1916493824, 87031590912, 4821352448), (304, 1824, 228)),
    "savp_bair64_bf16.train_b64_k4": (255974144212992, (3051823104, 73638749184, 8304721920), (132, 792, 88)),
}


@pytest.mark.parametrize("cell", sorted(UNITS))
def test_units_count_as_before_the_move(cell):
    entry, cfg, traffic = common.resolve(SPEC, cell)
    kind = importlib.import_module(f"benchmark.kinds.{traffic['kind']}")
    unit = kind.Cell(run.Context(entry, cfg, traffic, 1, "cpu"))
    flops, nbytes, events = UNITS[cell]
    work = unit.kernel_work()
    assert unit.flops_per_unit() == flops
    assert (work["bytes"]["K1"], work["bytes"]["K2"], work["bytes"]["K3"]) == nbytes
    assert (work["events"]["K1"], work["events"]["K2"], work["events"]["K3"]) == events

"""The port's benchmark tools (``video_prediction_torch.{bench_common, bench,
bench_generate, bench_probe}``) against the JAX package's, on the CPU.

- ``savp_bench_hparams`` equals the JAX function field for field, at each
  row's arguments and with an ``extra``; ``synthetic_batch`` gives the JAX
  bytes; the row tables equal ``bench.py``'s, read with ``ast`` (no JAX bench
  runs).
- The slice: from the same converted weights and the same noise, one train
  step of the bench's configuration (merged gate convs, bf16 compute and
  gates, ``scan_unroll=0``: the split mask input) at a small width, in JAX
  and in the port: every loss term under ``tests/test_torch_bf16.py``'s rule,
  max|port bf16 - jax bf16| <= 2 max|jax bf16 - jax fp32|; then the
  generation probe's rollout mean from the same weights and z, by the same
  rule. Each JAX jit takes the batch as an argument; ``scan_unroll=0``
  unrolls its 5 steps (the bench's setting): measured about 7 s for the four
  jits on one CPU thread.
- ``bench.main`` prints one JSON line with the JAX keys, finite losses and
  counted FLOPs, ``mfu`` null on the CPU; ``forward_flops`` is 2 x the MACs of
  every conv and dense layer (counted by forward hooks) plus the spectral
  norm's sigma ``einsum``; the ``RESULT`` lines of ``bench_generate`` and
  ``bench_probe``; without CUDA the tools raise unless given ``--device cpu``.
"""

import ast
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from video_prediction_torch import bench, bench_common, bench_generate, bench_probe, generate
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.ops.layers import Conv2D, Conv3D, Dense
from video_prediction_torch.ops.rnn import ConvLSTMCell
from video_prediction_torch.ops.spectral import SpectralLayer
from video_prediction_torch.train import profile_step
from video_prediction_torch.train.__main__ import main as train_main
from video_prediction_torch.train.state import TrainState, make_optimizers
from video_prediction_torch.train.step import make_train_step
from video_prediction_tpu import bench_common as jbench
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.train import create_train_state as j_create_train_state

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RATIO = 2.0  # tests/test_torch_bf16.py's rule
SMALL = "ngf=4,nef=8,ndf=4,nz=4"
T, SIZE, B = 6, 32, 2
TINY = ["--device", "cpu", "--sequence_length", str(T), "--size", str(SIZE)]


# ---------------------------------------------------------------------------
# bench_common against the JAX package's
# ---------------------------------------------------------------------------
ROW_ARGS = [
    dict(scan_unroll=bench.UNROLL[b], lstm_gate_conv=bench.GATE_CONV[b], gate_dtype=bench.GATE_DTYPE[b])
    for b in bench.BATCHES
]


@pytest.mark.parametrize("batch, kw, extra", [
    *[(b, kw, "") for b, kw in zip(bench.BATCHES, ROW_ARGS)],
    (48, dict(scan_unroll=6, lstm_gate_conv="split", prevent_cse=True, sequence_length=8, context_frames=3), ""),
    (2, dict(scan_unroll=0, lstm_gate_conv="merged", gate_dtype="bfloat16"),
     SMALL + ",disc_conv3d_taps=True,kl_anneal=none,decay_steps=[10, 20]"),
])
def test_savp_bench_hparams_equal_jax(batch, kw, extra):
    port = bench_common.savp_bench_hparams(batch, extra=extra, **kw)
    ref = jbench.savp_bench_hparams(batch, extra=extra, **kw)
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("args", [(3,), (2, 5, 16)])
def test_synthetic_batch_equals_jax_bytes(args):
    port = bench_common.synthetic_batch(*args, device="cpu")
    ref = jbench.synthetic_batch(*args)
    assert sorted(port) == sorted(ref) == ["images"]
    assert port["images"].dtype == torch.float32 and port["images"].device.type == "cpu"
    np.testing.assert_array_equal(port["images"].numpy(), np.asarray(ref["images"]))


def _bench_py_tables():
    """The module-level constants of the JAX package's ``bench.py``, parsed, not run."""
    tree = ast.parse((REPO / "bench.py").read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            name, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            name, value = node.target.id, node.value
        else:
            continue
        if name.isupper() and name != "PEAK_BF16_FLOPS":
            out[name] = ast.literal_eval(value)
    return out


def test_row_tables_equal_bench_py():
    tables = _bench_py_tables()
    assert sorted(tables) == ["BATCHES", "CONTEXT", "GATE_CONV", "GATE_DTYPE", "HEADLINE_BATCH", "PREVENT_CSE",
                              "REF_BASELINE_FRAMES_PER_SEC", "SEQ_LEN", "SIZE", "UNROLL"]
    for name in ("BATCHES", "GATE_CONV", "GATE_DTYPE", "HEADLINE_BATCH", "PREVENT_CSE", "REF_BASELINE_FRAMES_PER_SEC",
                 "UNROLL"):
        assert getattr(bench, name) == tables[name], name
    for name in ("CONTEXT", "SEQ_LEN", "SIZE"):
        assert getattr(bench_common, name) == tables[name], name


# ---------------------------------------------------------------------------
# the slice: one train step and the probe's rollout against JAX
# ---------------------------------------------------------------------------
def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _assert_ratio(port16, jax16, jax32, name):
    lhs = float(np.abs(_np(port16) - _np(jax16)).max())
    rhs = float(np.abs(_np(jax16) - _np(jax32)).max())
    assert rhs > 0.0, f"{name}: the bf16 run equals the fp32 run, the rule would be vacuous"
    assert lhs <= RATIO * rhs, f"{name}: max|port - jax_bf16| {lhs:.3g} > {RATIO} x max|jax_bf16 - jax_fp32| {rhs:.3g}"


def _noise(rng, b, t, hp):
    """The JAX train step's noise at step 0, as the port takes it (the key
    chain of ``tests/test_torch_train.py``)."""
    rng_fwd, rng_clip = jax.random.split(jax.random.fold_in(rng, 0))
    rng_ss, rng_q, rng_p = jax.random.split(rng_fwd, 3)
    clip_len = min(hp.clip_length, t - 1)
    return {
        "use_gt_u": torch.from_numpy(np.array(jax.random.uniform(rng_ss, (t - 1, b)))),
        "eps_q": torch.from_numpy(np.array(jax.random.normal(rng_q, (b, t - 1, hp.nz)))),
        "z_p": torch.from_numpy(np.array(jax.random.normal(rng_p, (b, t - 1, hp.nz)))),
        "clip_start": int(jax.random.randint(rng_clip, (), 0, t - 1 - clip_len + 1)),
    }


def _bench_hparams(module):
    """The bench's row hparams at a small width; the KL at full weight from
    step 0 (annealed, its term is 0 at step 0 in every dtype)."""
    return module.savp_bench_hparams(B, scan_unroll=0, lstm_gate_conv="merged", gate_dtype="bfloat16",
                                     sequence_length=T, extra=SMALL + ",kl_anneal=none")


def test_train_step_and_rollout_match_jax():
    """The bench's row configuration (merged gates, bf16) at a small width:
    the port's train step's loss terms, and the rollout mean of the
    generation probe, against the JAX package at bf16 and at fp32 from the
    same weights (every leaf moved off its init value) and noise."""
    jh = _bench_hparams(jbench)
    jh32 = jh.replace(compute_dtype="float32", gate_dtype="float32")
    batch = bench_common.synthetic_batch(B, T, SIZE, device="cpu")
    jbatch = {"images": jnp.asarray(batch["images"].numpy())}
    ts = j_create_train_state(j_get_model_class("savp")(jh32, mode="train"), jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) * (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
                              + 0.05 * rng.randn(*a.shape).astype(np.float32)), ts.params)
    step_rng = jax.random.fold_in(ts.rng, 0)

    ref_losses, ref_rollout = {}, {}
    for key, hp in (("b16", jh), ("f32", jh32)):
        jmodel = j_get_model_class("savp")(hp, mode="train")

        def losses(p, b, _m=jmodel):
            _, aux = _m.compute_losses(p, ts.model_state, b, step_rng, jnp.zeros((), jnp.int32), train=True)
            return {"g_loss": aux["g_loss"], "d_loss": aux["d_loss"],
                    **{f"g/{k}": v for k, v in aux["g_losses"].items()},
                    **{f"d/{k}": v for k, v in aux["d_losses"].items()}}

        def rollout(p, b, _m=jmodel):
            out = _m.forward(p, b, jax.random.PRNGKey(1), jnp.zeros((), jnp.int32), train=False)
            return out["gen_images"].mean(), out["zs_sampled_prior"]

        ref_losses[key] = jax.jit(losses)(params, jbatch)
        ref_rollout[key] = jax.jit(rollout)(params, jbatch)
    np.testing.assert_array_equal(np.asarray(ref_rollout["b16"][1]), np.asarray(ref_rollout["f32"][1]))

    th = _bench_hparams(bench_common)
    model = bench_common.build_model(th, batch)
    cells = [m for m in model.modules() if isinstance(m, ConvLSTMCell)]
    assert model.generator.cell.split_mask_input and cells and all(c.gate_conv == "merged" for c in cells)
    spectral = jax.tree_util.tree_map(np.asarray, ts.model_state["spectral"])
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params), {"discriminator": spectral}))

    mean = bench_common.rollout_mean(model, batch, zs_prior=torch.from_numpy(np.array(ref_rollout["b16"][1])))
    assert mean.dtype == torch.float32 and mean.shape == ()
    _assert_ratio(mean, ref_rollout["b16"][0], ref_rollout["f32"][0], "rollout mean")

    tstate = TrainState(model, *make_optimizers(model), step=0, rng=torch.Generator().manual_seed(0))
    scalars = make_train_step(model)(tstate, batch, noise=_noise(ts.rng, B, T, th))
    assert tstate.step == 1 and sorted(scalars) == sorted(ref_losses["b16"])
    for k, v in scalars.items():
        _assert_ratio(v, ref_losses["b16"][k], ref_losses["f32"][k], k)


# ---------------------------------------------------------------------------
# the tools end to end, on the CPU
# ---------------------------------------------------------------------------
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "device_kind", "timing", "rows", "generation"}
JAX_ROW_KEYS = {"frames_per_sec_per_chip", "ms_per_step", "mfu", "mfu_model", "flops_per_step",
                "model_flops_per_step"}
JAX_GEN_KEYS = {"gen_frames_per_sec_per_chip", "ms_per_rollout", "effective_batch"}


def test_bench_main_on_cpu(capsys):
    line = bench.main(TINY + ["--batches", "2", "--steps", "1", "--model_hparams", SMALL,
                              "--gen_batch", "1", "--gen_samples", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == line
    assert set(line) == JAX_KEYS | {"power_limit_w", "cudnn_allow_tf32"}
    assert line["metric"] == "train_frames_per_sec_per_chip_bair64_savp" and line["unit"] == "frames/sec/chip"
    assert line["device_kind"] == "cpu" and line["power_limit_w"] is None
    assert sorted(line["rows"]) == ["batch2"]
    row = line["rows"]["batch2"]
    assert set(row) == JAX_ROW_KEYS | {"peak_gib", "g_loss", "d_loss", "launches_per_step"}
    assert line["value"] == row["frames_per_sec_per_chip"] > 0
    assert line["vs_baseline"] == round(line["value"] / bench.REF_BASELINE_FRAMES_PER_SEC, 3)
    assert row["frames_per_sec_per_chip"] == pytest.approx(2 * (T - 2) / (row["ms_per_step"] / 1e3), rel=1e-3)
    assert np.isfinite(row["g_loss"]) and np.isfinite(row["d_loss"])
    assert row["flops_per_step"] > 0 and row["model_flops_per_step"] > 0
    assert row["mfu"] is None and row["mfu_model"] is None and row["peak_gib"] is None
    assert set(row["launches_per_step"].values()) == {0.0}  # the plain versions on the CPU: nothing launches
    gen = line["generation"]
    assert set(gen) == JAX_GEN_KEYS | {"acc", "compile_s", "peak_gib", "launches_per_rollout"}
    assert gen["effective_batch"] == 2 and np.isfinite(gen["acc"]) and gen["gen_frames_per_sec_per_chip"] > 0


def _counted_flops(model, fn, monkeypatch):
    """Run ``fn()`` and count, by kind of work:
    - ``layers``: 2 x the MACs of every conv and dense layer, from forward
      hooks (an output element takes one MAC a weight entry of its output
      channel: ``numel(y) * weight[0].numel()``), and of the mask head, which
      ``scan_unroll=0`` runs as two convs over its weight's slices
      (``models/savp.py#split_input_conv``, no module call);
    - ``sigma``: the spectral norm's sigma ``einsum`` of each spectral
      layer's call, as ``FlopCounterMode`` counts it on an operand of the
      same shape (a ``bmm``);
    - ``k3_plain``: K3's plain version's ``einsum`` (a ``bmm``, 2 x K MACs an
      output element), what the CPU runs in place of the kernel."""
    from video_prediction_torch.models import savp

    flops = {"layers": 0, "sigma": 0, "k3_plain": 0}

    def hook(module, args, out):
        y = out[0] if isinstance(module, SpectralLayer) else out
        flops["layers"] += 2 * y.numel() * module.weight[0].numel()
        if isinstance(module, SpectralLayer):
            w = module.weight.detach().reshape(module.weight.shape[0], -1).t()
            with FlopCounterMode(display=False) as counter:
                torch.einsum("i,ij,j->", torch.zeros(w.shape[0]), w, torch.zeros(w.shape[1]))
            flops["sigma"] += counter.get_total_flops()

    def split_input_conv(conv, a, b, _f=savp.split_input_conv):
        y = _f(conv, a, b)
        flops["layers"] += 2 * y.numel() * conv.weight[0].numel()
        return y

    def composite(candidates, *args, _f=savp.composite, **kw):
        out = _f(candidates, *args, **kw)
        flops["k3_plain"] += 2 * out[0].numel() * candidates.shape[1]
        return out

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv2D, Conv3D, Dense, SpectralLayer))]
    try:
        with monkeypatch.context() as patch:
            patch.setattr(savp, "split_input_conv", split_input_conv)
            patch.setattr(savp, "composite", composite)
            fn()
    finally:
        for h in handles:
            h.remove()
    return flops


def test_forward_flops_counts_every_conv_and_dense_layer(monkeypatch):
    """``forward_flops`` (``FlopCounterMode`` over one no-grad
    ``compute_losses``) of the bench's configuration at a small width is
    exactly 2 x the MACs of every conv and dense layer the loss runs, plus
    two remainders: the spectral norm's sigma ``einsum`` (a ``bmm``) and, on
    the CPU only, K3's plain version's ``einsum`` (on the card K3 is a CUDA
    kernel, not counted). Nothing else is counted: the power iteration's two
    matrix-vector products are ``aten.mv``, which has no FLOP formula, K1's
    plain version is elementwise, and so are K2's and the norms."""
    hp = _bench_hparams(bench_common)
    batch = bench_common.synthetic_batch(B, T, SIZE, device="cpu")
    model = bench_common.build_model(hp, batch)
    model.init_weights(torch.Generator().manual_seed(0))
    counted = _counted_flops(model, lambda: bench.forward_flops(model, batch), monkeypatch)
    total = bench.forward_flops(model, batch)
    assert min(counted.values()) > 0, counted
    assert total == sum(counted.values()), (total, counted)


def test_bench_generate_and_probe_result_lines(capsys):
    r = bench_generate.main(TINY + ["--batch", "1", "--samples", "2", "--rollouts", "1", "--hparams", SMALL])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"RESULT batch=1 samples=2 eff=2 unroll=0 gate=split gate_dtype=bfloat16 "
                        r"ms_per_rollout=\d+\.\d gen_frames_per_sec=\d+ compile_s=\d+", line), line
    assert set(r) == {"batch", "samples_per_rollout", "effective_batch", "unroll", "gate", "gate_dtype",
                      "ms_per_rollout", "gen_frames_per_sec", "compile_s", "acc"}
    assert np.isfinite(r["acc"])

    r = bench_probe.main(TINY + ["--batch", "2", "--steps", "1", "--gate", "merged", "--gate_dtype", "bfloat16",
                                 "--hparams", SMALL])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"RESULT batch=2 unroll=1 gate=merged prevent_cse=False gate_dtype=bfloat16 "
                        r"hparams='ngf=4,nef=8,ndf=4,nz=4' ms_per_step=\d+\.\d frames_per_sec=\d+\.\d "
                        r"compile_s=\d+ g_loss=\d+\.\d{4}", line), line
    assert np.isfinite(r["g_loss"])


@pytest.mark.parametrize("main, argv", [
    (bench.main, []),
    (bench_generate.main, []),
    (bench_probe.main, ["--batch", "2"]),
    (profile_step.main, []),
    (train_main, ["--output_dir", "unused"]),
    (generate.main, ["--checkpoint", "unused"]),
])
def test_tools_refuse_to_run_on_the_cpu_unasked(main, argv, monkeypatch):
    """Without CUDA and without ``--device cpu`` the bench tools and the
    profile, train and generate CLIs (``utils.device.device_or_raise``) raise
    before they build anything or read a file; they never carry on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_common, "build_model", lambda *a, **k: pytest.fail("built a model"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)

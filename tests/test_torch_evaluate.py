"""The port's evaluation path against the JAX package's, on the CPU:
``metrics_fn`` and the eval step of ``ours_savp`` from converted weights
with the JAX step's own prior draw; the ``ground_truth`` and ``repeat``
baselines; ``python -m video_prediction_torch.evaluate`` against
``scripts/evaluate.py`` on the baselines (file set, metric arrays, GIFs and
``index.html``); best-of-N against the same samples drawn one by one;
``--long``, ``--num_samples 0`` and the refusals; and the train CLI's eval
summaries. Small shapes: ngf=4, nef=8, nz=4 (64 px where the synthetic
dataset's CLI path needs it, 32 px otherwise)."""

import filecmp
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch import evaluate as t_evaluate
from video_prediction_torch import metrics as TM
from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.data.synthetic import SyntheticVideoDataset as TSynthetic
from video_prediction_torch.generate import batch_to_device
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.train.checkpoint import load_params, write_run_dir
from video_prediction_torch.train.step import make_eval_step as t_make_eval_step
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset as JSynthetic
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.train.step import make_eval_step as j_make_eval_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GEN_ATOL = 1e-4  # 5 recurrent fp32 steps, as tests/test_torch_model.py's rollouts
METRIC_RTOL = 1e-5  # PSNR in dB, SSIM and MSE of those frames
SMALL = dict(ngf=4, nef=8, ndf=4, nz=4)


def _hparams(module, config="ours_savp", model="savp", **extra):
    get_model_class = j_get_model_class if module is jhp else t_get_model_class
    zoo = module.zoo_dir() / "bair_action_free" / config / "model_hparams.json"
    return module.resolve_model_hparams(get_model_class(model).default_hparams(), str(zoo),
                                        extra={**SMALL, **extra})


def _batch(seq=6):
    raw = next(JSynthetic(mode="test", seed=0, image_size=32).make_iterator(2))
    return {"images": raw["images"][:, :seq], "actions": raw["actions"][:, :seq]}


def test_eval_step_and_metrics_fn_match_jax():
    """``eval_step`` of ``ours_savp``: the JAX step's prior draw (``forward``
    splits its key into ss/q/p and draws ``z_p`` from p, ``models/base.py:259,
    299``) is given to the port as ``zs_prior``."""
    jh, th = _hparams(jhp, sequence_length=6), _hparams(thp, sequence_length=6)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = j_get_model_class("savp")(jh, mode="test")
    params, state = jmodel.init_variables(jax.random.PRNGKey(0), jbatch)
    rng = jax.random.PRNGKey(5)
    jgen, jmetrics = j_make_eval_step(jmodel)(params, jbatch, rng)
    z = np.array(jax.random.normal(jax.random.split(rng, 3)[2], (2, 5, 4)))

    tmodel = t_get_model_class("savp")(th, image_shape=(32, 32, 3), action_dim=4)
    tmodel.load_state_dict(flax_to_state_dict(params, {"discriminator": state.get("spectral", {})}))
    tgen, tmetrics = t_make_eval_step(tmodel)({k: torch.from_numpy(v) for k, v in batch.items()},
                                              zs_prior=torch.from_numpy(z))
    assert tgen.shape == (2, 5, 32, 32, 3) and not tgen.requires_grad
    np.testing.assert_allclose(tgen.numpy(), np.asarray(jgen), atol=GEN_ATOL, rtol=0)
    assert sorted(tmetrics) == sorted(jmetrics) == ["mse", "psnr", "psnr_per_frame", "ssim", "ssim_per_frame"]
    assert tmetrics["psnr_per_frame"].shape == (4,)  # frames context..T-1
    for k in tmetrics:
        np.testing.assert_allclose(tmetrics[k].numpy(), np.asarray(jmetrics[k]), rtol=METRIC_RTOL, err_msg=k)


@pytest.mark.parametrize("name", ["ground_truth", "repeat"])
def test_baselines_match_jax(name):
    jh, th = jhp.ModelHparams(context_frames=3), thp.ModelHparams(context_frames=3)
    batch = _batch()
    jmodel = j_get_model_class(name)(jh)
    assert jmodel.init_variables(jax.random.PRNGKey(0), batch) == ({}, {})
    jout = jmodel.forward({}, {k: jnp.asarray(v) for k, v in batch.items()}, None, 0, False)
    tmodel = t_get_model_class(name)(th, image_shape=(32, 32, 3), action_dim=4)
    assert not tmodel.trainable and not list(tmodel.parameters())
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tout = tmodel(tbatch, train=False)
    np.testing.assert_array_equal(tout["gen_images"].numpy(), np.asarray(jout["gen_images"]))
    metrics = tmodel.metrics_fn(tout, tbatch)
    if name == "ground_truth":
        assert torch.isinf(metrics["psnr"]) and abs(float(metrics["ssim"]) - 1.0) < 1e-6


def _jax_evaluate(argv):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import evaluate as j_evaluate
    finally:
        sys.path.remove(str(REPO / "scripts"))
    j_evaluate.main(argv)


@pytest.fixture(scope="module")
def record_dirs(tmp_path_factory):
    """Test records at each dataset's own 64x64 schema, written by TensorFlow:
    ``bair`` (raw frames, actions, states) and ``kth`` (JPEG frames by PIL),
    30 frames, 4 records each."""
    import io

    from PIL import Image

    tf = pytest.importorskip("tensorflow")
    root = tmp_path_factory.mktemp("eval_records")
    rng = np.random.RandomState(0)

    def feature(kind, v):
        if kind == "bytes":
            return tf.train.Feature(bytes_list=tf.train.BytesList(value=v))
        return tf.train.Feature(float_list=tf.train.FloatList(value=v))

    dirs = {}
    for name in ("bair", "kth"):
        (root / name).mkdir()
        with tf.io.TFRecordWriter(str(root / name / f"{name}.tfrecord")) as w:
            for _ in range(4):
                base = rng.randint(0, 200, (64, 64, 3))
                feat = {}
                for i in range(30):
                    img = np.clip(base + 2 * i + rng.randint(0, 40, (64, 64, 3)), 0, 255).astype(np.uint8)
                    if name == "bair":
                        feat[f"{i}/image_aux1/encoded"] = feature("bytes", [img.tobytes()])
                        feat[f"{i}/action"] = feature("float", rng.rand(4))
                        feat[f"{i}/endeffector_pos"] = feature("float", rng.rand(3))
                    else:
                        buf = io.BytesIO()
                        Image.fromarray(img).save(buf, format="JPEG", quality=95)
                        feat[f"{i}/image/encoded"] = feature("bytes", [buf.getvalue()])
                w.write(tf.train.Example(features=tf.train.Features(feature=feat)).SerializeToString())
        dirs[name] = str(root / name)
    return dirs


@pytest.mark.parametrize("name,dataset", [
    pytest.param("ground_truth", "synthetic", id="ground_truth"),
    pytest.param("repeat", "synthetic", id="repeat"),
    pytest.param("ground_truth", "bair", id="ground_truth-bair"),
    pytest.param("repeat", "bair", id="repeat-bair"),
    pytest.param("ground_truth", "kth", id="ground_truth-kth"),
    pytest.param("repeat", "kth", id="repeat-kth"),
])
def test_cli_matches_the_jax_cli_on_the_baselines(name, dataset, tmp_path, request, monkeypatch):
    """On the synthetic dataset with one sample; on BAIR and KTH test records
    (``--input_dir``) with best of 2, the JAX CLI on its native backend, which
    the port's reader equals (``tests/test_torch_data.py``)."""
    common = ["--model", name, "--dataset", dataset, "--batch_size", "2", "--num_samples", "3"]
    files = ["psnr.txt", "ssim.txt"]
    if dataset != "synthetic":
        common += ["--input_dir", request.getfixturevalue("record_dirs")[dataset], "--num_stochastic_samples", "2"]
        files = ["psnr_avg.txt", "psnr_max.txt", "ssim_avg.txt", "ssim_max.txt"]
        monkeypatch.setenv("VP_DATA_BACKEND", "native")
    summary = t_evaluate.main(common + ["--results_dir", str(tmp_path / "port"), "--device", "cpu"])
    _jax_evaluate(common + ["--results_dir", str(tmp_path / "jax")])
    port, ref = tmp_path / "port" / dataset / name, tmp_path / "jax" / dataset / name
    assert summary["results_dir"] == str(port) and summary["no_nan"]
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == ["images", "index.html"] + files
    gifs = sorted(os.listdir(ref / "images"))
    assert sorted(os.listdir(port / "images")) == gifs and len(gifs) == 6
    for f in gifs + ["../index.html"]:
        assert filecmp.cmp(port / "images" / f, ref / "images" / f, shallow=False), f
    for f in files:
        a, b = np.loadtxt(port / f), np.loadtxt(ref / f)
        assert a.shape == b.shape == (3, 10)
        if name == "ground_truth" and f.startswith("psnr"):
            # The port normalizes the target and the prediction with one op on
            # the device, so they are equal and the PSNR is inf. The JAX CLI
            # divides the target by 255 on the host and the prediction in XLA,
            # which multiplies by 1/255 instead: one ulp apart on 126 of the
            # 256 byte values, an MSE near 1e-17 and about 161 dB on the
            # synthetic frames. On the records' brighter, busier frames more
            # pixels sit in [0.5, 1), where an ulp is 2^-24: no pixel off by
            # more than that bounds the MSE by 2^-48, the PSNR by 144.5 dB.
            floor = 150.0 if dataset == "synthetic" else -10.0 * np.log10(2.0**-48)
            assert np.isinf(a).all() and (b > floor).all()
            continue
        np.testing.assert_allclose(a, b, rtol=METRIC_RTOL, atol=0, err_msg=f)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """Run directories with seeded weights at the synthetic dataset's 64 px:
    ``ours_savp`` (with its two discriminators) trained at T=12, and ``sv2p``
    at T=6."""
    root = tmp_path_factory.mktemp("eval_runs")
    dirs = {}
    for config, model_name, seq in (("ours_savp", "savp", 12), ("sv2p", "sv2p", 6)):
        hp = _hparams(thp, config, model_name, sequence_length=seq)
        model = t_get_model_class(model_name)(hp, image_shape=(64, 64, 3), action_dim=4)
        model.init_weights(torch.Generator().manual_seed(0))
        dirs[config] = str(root / config)
        write_run_dir(dirs[config], model_name, "synthetic", hp, thp.DatasetHparams(sequence_length=seq), model)
    return dirs


@pytest.mark.parametrize("config", ["ours_savp", "sv2p"])
def test_cli_writes_the_stochastic_file_set(config, run_dirs, tmp_path):
    summary = t_evaluate.main(["--checkpoint", run_dirs[config], "--results_dir", str(tmp_path), "--device", "cpu",
                               "--batch_size", "2", "--num_samples", "2", "--num_stochastic_samples", "2",
                               "--sequence_length", "5"])
    model_name = "sv2p" if config == "sv2p" else "savp"
    out = tmp_path / "synthetic" / model_name
    assert summary["rollouts"] == 1 and summary["no_nan"]
    assert sorted(os.listdir(out)) == ["images", "index.html", "psnr_avg.txt", "psnr_max.txt", "ssim_avg.txt",
                                       "ssim_max.txt"]
    for name in ("psnr", "ssim"):
        best, mean = np.loadtxt(out / f"{name}_max.txt"), np.loadtxt(out / f"{name}_avg.txt")
        assert best.shape == mean.shape == (2, 3) and np.isfinite(best).all()
        assert (best >= mean - 1e-6).all()
    assert len(os.listdir(out / "images")) == 4


def test_best_of_n_equals_samples_drawn_one_by_one(run_dirs, tmp_path):
    """Chunks of 2 samples over 3 (the second chunk keeps 1), 2 batches of 2
    for 3 examples: the files equal a numpy max and mean over the same prior
    draws, rolled out one sample at a time on the untiled batch."""
    seed, seq = 11, 5
    t_evaluate.main(["--checkpoint", run_dirs["ours_savp"], "--results_dir", str(tmp_path), "--device", "cpu",
                     "--batch_size", "2", "--num_samples", "3", "--num_stochastic_samples", "3",
                     "--samples_per_rollout", "2", "--sequence_length", str(seq), "--seed", str(seed),
                     "--only_metrics"])
    out = tmp_path / "synthetic" / "savp"
    assert sorted(os.listdir(out)) == ["psnr_avg.txt", "psnr_max.txt", "ssim_avg.txt", "ssim_max.txt"]

    model = t_get_model_class("savp")(_hparams(thp, sequence_length=12), image_shape=(64, 64, 3), action_dim=4)
    load_params(run_dirs["ours_savp"], model)
    dataset = TSynthetic(mode="test", seed=seed, hparams=thp.DatasetHparams(sequence_length=seq))
    next(dataset.make_iterator(2))  # the CLI's shape batch
    it = dataset.make_iterator(2)
    rng = torch.Generator().manual_seed(seed)
    vals = {"psnr": [], "ssim": []}
    with torch.no_grad():
        for _ in range(2):
            batch = batch_to_device(next(it), "cpu")
            target = batch["images"][:, 2:].float() / 255.0
            zs = [torch.randn((4, seq - 1, 4), generator=rng).reshape(2, 2, seq - 1, 4) for _ in range(2)]
            samples = [zs[0][:, 0], zs[0][:, 1], zs[1][:, 0]]  # each example repeated k=2 times in a row
            per = {"psnr": [], "ssim": []}
            for z in samples:
                pred = model(batch, zs_prior=z)["gen_images"][:, 1:]
                per["psnr"].append(TM.peak_signal_to_noise_ratio(target, pred).numpy())
                per["ssim"].append(TM.structural_similarity(target, pred).numpy())
            for m in vals:
                vals[m].append(np.stack(per[m], axis=1))  # [B, N, Tp]
    for m in vals:
        allv = np.concatenate(vals[m])[:3]
        np.testing.assert_allclose(np.loadtxt(out / f"{m}_max.txt"), allv.max(axis=1), rtol=METRIC_RTOL, err_msg=m)
        np.testing.assert_allclose(np.loadtxt(out / f"{m}_avg.txt"), allv.mean(axis=1), rtol=METRIC_RTOL, err_msg=m)


def test_long_rollout_restores_a_model_with_discriminators(run_dirs, tmp_path):
    """Trained at T=12 with clip_length 10 and two discriminators, evaluated
    at T=30 (and at T=5 in the test above, below the clip length): the model
    keeps the trained length for its parameter shapes, so ``params.pt``
    restores, and the generator rolls out at the data's length."""
    t_evaluate.main(["--checkpoint", run_dirs["ours_savp"], "--results_dir", str(tmp_path), "--device", "cpu",
                     "--batch_size", "1", "--num_samples", "1", "--long", "--only_metrics"])
    psnr = np.loadtxt(tmp_path / "synthetic" / "savp" / "psnr.txt")
    assert psnr.shape == (28,) and np.isfinite(psnr).all()  # one row of T - context = 30 - 2 frames


def test_num_samples_zero_walks_the_whole_test_set(tmp_path):
    t_evaluate.main(["--model", "repeat", "--dataset", "synthetic", "--dataset_hparams", "sequence_length=4",
                     "--results_dir", str(tmp_path), "--device", "cpu", "--batch_size", "48", "--num_samples", "0",
                     "--only_metrics"])
    psnr = np.loadtxt(tmp_path / "synthetic" / "repeat" / "psnr.txt")
    assert psnr.shape == (TSynthetic().num_examples_per_epoch(), 2) == (256, 2)


def test_refusals(run_dirs, tmp_path):
    with pytest.raises(SystemExit, match="trainable; --checkpoint is required"):
        t_evaluate.main(["--model", "savp", "--dataset", "synthetic", "--results_dir", str(tmp_path),
                         "--device", "cpu"])
    with pytest.raises(SystemExit, match="--model and --dataset"):
        t_evaluate.main(["--model", "repeat", "--results_dir", str(tmp_path), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_evaluate.main(["--checkpoint", run_dirs["sv2p"], "--results_dir", str(tmp_path), "--device", "cuda"])


def test_train_cli_eval_firings_walk_the_val_set(tmp_path, monkeypatch):
    """Two eval firings draw 16 different validation batches from one
    iterator (a fresh iterator per firing would re-read the first 8), and the
    CLI returns the eval and schedule summaries."""
    from video_prediction_torch.train.__main__ import main as train_main

    seen = []
    make_iterator = TSynthetic.make_iterator

    def spy(self, batch_size):
        for batch in make_iterator(self, batch_size):
            if self.mode == "val":
                seen.append(batch["images"].tobytes())
            yield batch

    monkeypatch.setattr(TSynthetic, "make_iterator", spy)
    zoo = REPO / "hparams" / "bair_action_free" / "ours_savp" / "model_hparams.json"
    summary = train_main(["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(zoo),
                          "--model_hparams", "ngf=4,nef=8,ndf=4,nz=4,sequence_length=4,clip_length=3",
                          "--output_dir", str(tmp_path), "--max_steps", "2", "--batch_size", "2", "--device", "cpu",
                          "--progress_freq", "0", "--save_freq", "0", "--summary_freq", "1",
                          "--eval_summary_freq", "1", "--accum_eval_summary_freq", "0"])
    assert len(seen) == 16, len(seen)  # 2 firings x 8 batches
    assert len(set(seen)) == 16, "an eval firing re-read validation batches"
    s = summary["summaries"]
    for tag in ("g_loss", "lr", "schedule_sampling_prob", "kl_weight", "eval/psnr", "eval/ssim", "eval/mse"):
        assert tag in s and np.isfinite(s[tag]), tag
    assert not any(k.startswith("accum_eval/") for k in s)
    assert s["lr"] == pytest.approx(2e-4) and 0.0 < s["schedule_sampling_prob"] <= 1.0

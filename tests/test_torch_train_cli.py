"""The port's training CLI (``python -m video_prediction_torch.train``) end to
end on the CPU at a small width: 2 steps, then ``--resume`` to 3, which
restores the whole train state (step, parameters, spectral u, both Adam
states, the noise generator) and trains step 3 on the first batch of the
data stream opened afresh, as ``scripts/train.py`` resumes; the losses it
reports; the run directory it writes is one ``generate`` reads; a params
file without discriminators still loads for generation; ``--profile_steps``
writes a trace and leaves the losses as they were; ``--steps_per_call``
fires each frequency on the crossing of one of its multiples, overshoots
``--max_steps`` and resumes, also from a run of one step a call; two ranks
over gloo write from rank 0 only, seed their streams ``--seed`` plus their
rank and resume from and into one process."""

import json
import os
import shutil
import textwrap
from pathlib import Path

import pytest
import torch

from video_prediction_torch import generate
from video_prediction_torch.configs.hparams import DatasetHparams, ModelHparams, apply_overrides
from video_prediction_torch.data.synthetic import SyntheticVideoDataset
from video_prediction_torch.models import get_model_class
from video_prediction_torch.train.__main__ import main as train_main
from video_prediction_torch.train.checkpoint import (
    CHECKPOINT_DIR,
    PARAMS_FILE,
    TRAIN_STATE_FILE,
    checkpoint_file,
    load_params,
    load_train_state,
    save_train_state,
)
from video_prediction_torch.train.state import create_train_state
from video_prediction_torch.train.step import make_train_step

torch.set_num_threads(1)

ZOO = Path(__file__).resolve().parent.parent / "hparams" / "bair_action_free" / "ours_savp" / "model_hparams.json"
SMALL = "ngf=4,nef=8,ndf=4,nz=4,sequence_length=5,clip_length=4,schedule_sampling_k=2.0,kl_anneal_steps=[0, 2]"
SEED = 3


def _train(run_dir, steps, resume=False, extra=()):
    argv = ["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(ZOO), "--model_hparams", SMALL,
            "--output_dir", str(run_dir), "--max_steps", str(steps), "--batch_size", "2", "--device", "cpu",
            "--progress_freq", "1", "--save_freq", "2", "--seed", str(SEED), *extra]
    return train_main(argv + (["--resume"] if resume else []))


def _model(run_dir):
    with open(os.path.join(run_dir, "model_hparams.json")) as f:
        hp = apply_overrides(ModelHparams(), json.load(f))
    return get_model_class("savp")(hp, image_shape=(64, 64, 3), action_dim=4)  # the synthetic dataset's shapes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    first = _train(root / "resumed", 2)
    shutil.copytree(root / "resumed", root / "step2")  # the state the resume starts from
    resumed = _train(root / "resumed", 3, resume=True)
    whole = _train(root / "whole", 3)
    return root, first, resumed, whole


def _assert_same_state(a, b):
    """Two saved train states hold the same step, parameters and buffers,
    Adam slots of both optimizers, and noise generator state."""
    assert a["step"] == b["step"]
    assert sorted(a["model"]) == sorted(b["model"])
    for k in b["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for opt in ("opt_g", "opt_d"):
        assert sorted(a[opt]["state"]) == sorted(b[opt]["state"]) and b[opt]["state"]
        for i, slots in b[opt]["state"].items():
            for name, v in slots.items():
                assert torch.equal(a[opt]["state"][i][name], v), (opt, i, name)
    assert torch.equal(a["rng"], b["rng"])


def test_resume_equals_an_unbroken_run(runs):
    """The resumed step equals one unbroken train step from the restored
    step-2 state on the fresh stream's first batch: ``scripts/train.py:170-190``
    restores the state and trains on a stream that starts again at its init
    example, without replaying the batches the first run took."""
    root, first, resumed, whole = runs
    assert (first["start_step"], first["step"]) == (0, 2)
    assert (resumed["start_step"], resumed["step"]) == (2, 3)
    assert whole["step"] == 3 and resumed["all_finite"] and whole["all_finite"]

    # step 3 by hand: the step-2 checkpoint, then one train step on next(fresh iterator)
    model = _model(root / "step2")
    ts = create_train_state(model, SEED, "cpu")
    load_train_state(str(root / "step2"), ts)
    assert ts.step == 2
    with open(root / "step2" / "dataset_hparams.json") as f:
        dhp = apply_overrides(DatasetHparams(), json.load(f))
    batch = next(SyntheticVideoDataset("", mode="train", hparams=dhp, seed=SEED).make_iterator(2))
    scalars = make_train_step(model)(ts, generate.batch_to_device(batch, "cpu"))
    assert resumed["scalars"] == {k: float(v) for k, v in scalars.items()}
    state = root / "by_hand"
    save_train_state(str(state), ts)
    a = torch.load(checkpoint_file(root / "resumed", TRAIN_STATE_FILE), weights_only=True)
    _assert_same_state(a, torch.load(checkpoint_file(state, TRAIN_STATE_FILE), weights_only=True))
    # the unbroken run trained step 3 on the stream's third batch: another state
    b = torch.load(checkpoint_file(root / "whole", TRAIN_STATE_FILE), weights_only=True)
    assert a["step"] == b["step"] == 3 and torch.equal(a["rng"], b["rng"])
    assert any(not torch.equal(a["model"][k], b["model"][k]) for k in b["model"])


def test_losses_reported_and_spectral_u_moved(runs):
    root, _, _, whole = runs
    assert set(whole["scalars"]) == {
        "g_loss", "d_loss", "g/l1", "g/kl", "g/video_gan", "g/video_vae_gan", "g/video_vae_gan_feat",
        "d/video_gan_real", "d/video_gan_fake", "d/video_vae_gan_real", "d/video_vae_gan_fake",
    }
    init = _model(root / "whole")
    init.init_weights(torch.Generator().manual_seed(SEED))  # what the run started from
    trained = torch.load(checkpoint_file(root / "whole", PARAMS_FILE), weights_only=True)
    for key in ("video", "video_vae"):
        for layer in ("sn_conv3d0", "sn_conv3d5"):  # sn_fc has one output: its u is 1
            name = f"discriminator.{key}.{layer}.u"
            assert not torch.allclose(trained[name], init.state_dict()[name]), name
            assert abs(float(trained[name].norm()) - 1.0) < 1e-5


def test_generate_reads_the_training_run_dir(runs, tmp_path):
    summary = generate.main(["--checkpoint", str(runs[0] / "whole"), "--results_dir", str(tmp_path),
                             "--device", "cpu", "--batch_size", "2", "--num_samples", "2"])
    assert summary["gifs"] == 2 and summary["all_finite"]


def test_params_without_discriminators_load_for_generation(runs, tmp_path):
    state = torch.load(checkpoint_file(runs[0] / "whole", PARAMS_FILE), weights_only=True)
    old = tmp_path / CHECKPOINT_DIR / PARAMS_FILE  # the flat layout of a run directory written before steps
    old.parent.mkdir(parents=True)
    torch.save({k: v for k, v in state.items() if not k.startswith("discriminator.")}, old)
    model = _model(runs[0] / "whole")
    load_params(str(tmp_path), model)
    assert torch.equal(model.generator.cell.stem.weight, state["generator.cell.stem.weight"])
    torch.save({k: v for k, v in state.items() if not k.startswith("generator.cell.stem")}, old)
    with pytest.raises(RuntimeError, match="missing"):
        load_params(str(tmp_path), model)
    torch.save({**state, "bogus": torch.zeros(1)}, old)
    with pytest.raises(RuntimeError, match="unexpected"):
        load_params(str(tmp_path), model)


# ---- TFRecords: BAIR-schema records written by TensorFlow ------------------ #


@pytest.fixture(scope="module")
def bair_dirs(tmp_path_factory):
    """``train/`` (4 records) and ``val/`` (3 other records) of 30 raw 64x64
    frames with 4-D actions and 3-D states, as ``tests/test_data.py`` writes
    them."""
    import numpy as np

    tf = pytest.importorskip("tensorflow")
    root = tmp_path_factory.mktemp("bair_records")
    rng = np.random.RandomState(0)
    for split, n in (("train", 4), ("val", 3)):
        (root / split).mkdir()
        with tf.io.TFRecordWriter(str(root / split / f"{split}.tfrecord")) as w:
            for _ in range(n):
                feat = {}
                for i in range(30):
                    img = rng.randint(0, 256, (64, 64, 3), np.uint8)
                    feat[f"{i}/image_aux1/encoded"] = tf.train.Feature(
                        bytes_list=tf.train.BytesList(value=[img.tobytes()]))
                    feat[f"{i}/action"] = tf.train.Feature(float_list=tf.train.FloatList(value=rng.rand(4)))
                    feat[f"{i}/endeffector_pos"] = tf.train.Feature(float_list=tf.train.FloatList(value=rng.rand(3)))
                w.write(tf.train.Example(features=tf.train.Features(feature=feat)).SerializeToString())
    return str(root / "train"), str(root / "val")


def test_train_on_bair_records_evaluates_on_val_input_dir(bair_dirs, tmp_path, monkeypatch):
    """2 steps at ngf=4 on BAIR records scaled to 32 px; the eval firing at
    step 2 reads ``--val_input_dir``, and without it ``--input_dir``
    (``scripts/train.py:143``); ``generate`` reads the run dir on the
    records."""
    from video_prediction_torch.data import loader
    from video_prediction_torch.data.native_loader import NativeVideoPipeline

    train_dir, val_dir = bair_dirs
    opened, fed = [], []
    pipeline_init, feeder_init = NativeVideoPipeline.__init__, loader.DeviceFeeder.__init__

    def spy_pipeline(self, dataset, batch_size):
        opened.append((dataset.mode, dataset.input_dir))
        pipeline_init(self, dataset, batch_size)

    def spy_feeder(self, host_iterator, device, **kwargs):
        fed.append(str(device))
        feeder_init(self, host_iterator, device, **kwargs)

    monkeypatch.setattr(NativeVideoPipeline, "__init__", spy_pipeline)
    monkeypatch.setattr(loader.DeviceFeeder, "__init__", spy_feeder)
    argv = ["--dataset", "bair", "--input_dir", train_dir, "--dataset_hparams", "scale_size=32", "--model", "savp",
            "--model_hparams_dict", str(ZOO), "--model_hparams", SMALL, "--batch_size", "2", "--device", "cpu",
            "--progress_freq", "1", "--eval_summary_freq", "2", "--accum_eval_summary_freq", "0", "--seed", str(SEED)]
    run = tmp_path / "run"
    summary = train_main(argv + ["--val_input_dir", val_dir, "--output_dir", str(run), "--max_steps", "2"])
    assert summary["step"] == 2 and summary["all_finite"]
    assert {"eval/psnr", "eval/ssim"} <= set(summary["summaries"])
    assert opened == [("train", train_dir), ("val", val_dir)] and fed == ["cpu"]

    opened.clear()
    summary = train_main(argv + ["--output_dir", str(tmp_path / "run_same_dir"), "--max_steps", "2"])
    assert summary["all_finite"] and opened == [("train", train_dir), ("val", train_dir)]

    with open(run / "options.json") as f:
        assert json.load(f)["dataset"] == "bair"
    gen = generate.main(["--checkpoint", str(run), "--input_dir", val_dir, "--results_dir", str(tmp_path / "gen"),
                         "--device", "cpu", "--batch_size", "2", "--num_samples", "2"])
    assert gen["gifs"] == 2 and gen["all_finite"]
    assert opened[-1] == ("test", val_dir)


def test_dna_on_bair_records_with_states_then_evaluate(bair_dirs, tmp_path):
    """``--model dna`` with ``hparams/bair/dna_l2`` on BAIR records read with
    ``use_state=True``: 2 steps, whose losses carry the ``state`` term; the
    stem conv takes the image, the 4 action and the 3 state channels; then
    ``evaluate`` on the records from the run dir."""
    from video_prediction_torch import evaluate

    train_dir, val_dir = bair_dirs
    zoo = ZOO.parent.parent.parent / "bair" / "dna_l2" / "model_hparams.json"
    run = tmp_path / "dna"
    summary = train_main(["--dataset", "bair", "--input_dir", train_dir, "--dataset_hparams",
                          "scale_size=32,use_state=True", "--model", "dna", "--model_hparams_dict", str(zoo),
                          "--model_hparams", "ngf=4,sequence_length=5", "--output_dir", str(run), "--max_steps", "2",
                          "--batch_size", "2", "--device", "cpu", "--progress_freq", "1", "--eval_summary_freq", "0",
                          "--accum_eval_summary_freq", "0", "--seed", str(SEED)])
    assert summary["step"] == 2 and summary["all_finite"]
    assert {"g/l2", "g/state"} <= set(summary["scalars"])
    params = torch.load(checkpoint_file(run, PARAMS_FILE), weights_only=True)
    assert params["generator.cell.stem.weight"].shape[1] == 3 + 4 + 3
    assert "generator.cell.dna_head.weight" in params and "generator.cell.state_head.weight" in params
    out = evaluate.main(["--checkpoint", str(run), "--input_dir", val_dir, "--results_dir", str(tmp_path / "eval"),
                         "--device", "cpu", "--batch_size", "2", "--num_samples", "2"])
    assert out["rollouts"] == 1 and out["no_nan"] and out["results_dir"].endswith(os.path.join("bair", "dna"))


def test_checkpoint_warm_starts_matching_params(tmp_path):
    """``--checkpoint RUN_DIR`` copies the params that match by name and shape
    from another run (``scripts/train.py:191-194``): an ``sna`` run from a
    ``savp`` run takes the shared layers (the CDNA head, the downsampling
    convs, the recurrent convs over h) and keeps its own init for what
    differs in shape (the stem and the encoder's input gate convs, which take
    3 state dims and no z; the mask head, over the top features only) and
    for what the ``savp`` run lacks (the state head). Without the flag
    nothing is copied."""
    from video_prediction_torch.train.checkpoint import warm_start

    savp_run, sna_run = tmp_path / "savp", tmp_path / "sna"
    _train(savp_run, 1)
    zoo = ZOO.parent.parent.parent / "bair" / "sna_l2" / "model_hparams.json"
    argv = ["--dataset", "synthetic", "--model", "sna", "--model_hparams_dict", str(zoo),
            "--model_hparams", "ngf=4,sequence_length=5", "--max_steps", "1", "--batch_size", "2", "--device", "cpu",
            "--progress_freq", "1", "--seed", str(SEED)]
    summary = train_main(argv + ["--output_dir", str(sna_run), "--checkpoint", str(savp_run)])
    copied = set(summary["warm_started"])
    assert summary["step"] == 1 and summary["all_finite"]
    assert {"generator.cell.cdna_head.weight", "generator.cell.down1.conv.weight",
            "generator.cell.enc_rnn1.gates_h.weight", "generator.cell.dec_rnn0.ln"} <= copied
    assert not {"generator.cell.stem.weight", "generator.cell.enc_rnn1.gates_x.weight",
                "generator.cell.mask_head.weight", "generator.cell.state_head.weight"} & copied
    assert not [n for n in copied if n.startswith("discriminator.")]  # sna has none
    assert train_main(argv + ["--output_dir", str(tmp_path / "fresh")])["warm_started"] == []

    # the values: each copied tensor is the source's, every other keeps its init
    source = torch.load(checkpoint_file(savp_run, PARAMS_FILE), weights_only=True)
    with open(sna_run / "model_hparams.json") as f:
        hp = apply_overrides(ModelHparams(), json.load(f))
    model = get_model_class("sna")(hp, image_shape=(64, 64, 3), action_dim=4, state_dim=3)
    model.init_weights(torch.Generator().manual_seed(SEED))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    assert sorted(warm_start(str(savp_run), model)) == sorted(copied)
    for name, value in model.state_dict().items():
        assert torch.equal(value, source[name] if name in copied else init[name]), name


def test_profile_steps_writes_a_trace_and_keeps_the_losses(runs, capsys):
    """``--profile_steps 1,2`` records the second and third steps under
    ``torch.profiler`` and writes the trace to ``output_dir/profile/``, with
    the port's spans (``utils/trace.py``) as a process of their own; the
    run's losses equal those of the same run without it. With
    ``--steps_per_call 2`` the ``multistep.*`` spans are in the file."""
    root, _, _, whole = runs
    profiled = _train(root / "profiled", 3, extra=["--profile_steps", "1,2"])
    assert profiled["step"] == 3 and profiled["scalars"] == whole["scalars"]
    trace = root / "profiled" / "profile" / "trace_1-2.json"
    assert f"profile of steps 1-2: {trace}" in capsys.readouterr().out
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names)  # the steps' operators are in it
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert sum(e["name"] == "model.rollout" for e in spans) >= 2 and any(e["name"] == "savp.step" for e in spans)
    _train(root / "profiled_spc", 2, extra=["--profile_steps", "0,1", "--steps_per_call", "2", "--no_tensorboard"])
    with open(root / "profiled_spc" / "profile" / "trace_0-1.json") as f:
        spans = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "program_span"]
    assert {"multistep.call", "multistep.noise", "feeder.wait"} <= {e["name"] for e in spans}


@pytest.mark.parametrize("spec", ["2,1", "-1,2", "3"])
def test_profile_steps_refuses_a_bad_window(spec, tmp_path):
    with pytest.raises(ValueError):
        _train(tmp_path / "bad", 1, extra=[f"--profile_steps={spec}"])


# ---- --steps_per_call: K steps a call ------------------------------------- #


def _spc_argv(run_dir, steps, spc):
    """The flags of ``tests/test_cli_e2e.py:87-115``'s fused-dispatch run."""
    return ["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(ZOO), "--model_hparams", SMALL,
            "--output_dir", str(run_dir), "--max_steps", str(steps), "--batch_size", "2", "--device", "cpu",
            "--seed", str(SEED), "--steps_per_call", str(spc), "--save_freq", "4", "--progress_freq", "2",
            "--summary_freq", "0", "--eval_summary_freq", "0", "--image_summary_freq", "0", "--no_tensorboard"]


def test_steps_per_call_fires_on_crossings_overshoots_and_resumes(tmp_path, monkeypatch, capsys):
    """``--steps_per_call 2 --max_steps 5`` ends at 6 (three calls); save
    (``--save_freq 4``) and progress (``--progress_freq 2``) fire when one of
    their multiples falls in a call's steps; ``--resume`` to 8 takes one more
    call from step 6 (``tests/test_cli_e2e.py:87-115``)."""
    from video_prediction_torch.train import checkpoint

    saved = []
    save = checkpoint.save_train_state

    def record(run_dir, ts):
        saved.append(ts.step)
        return save(run_dir, ts)

    monkeypatch.setattr(checkpoint, "save_train_state", record)
    run = tmp_path / "spc"
    first = train_main(_spc_argv(run, 5, 2))
    assert (first["start_step"], first["step"]) == (0, 6) and first["all_finite"]
    assert saved == [4, 6]  # the crossing of 4, then the end of the run
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines() if line.startswith("step ")] == ["step 2", "step 4",
                                                                                           "step 6"]
    resumed = train_main(_spc_argv(run, 8, 2) + ["--resume"])
    assert "resumed from step 6" in capsys.readouterr().out
    assert (resumed["start_step"], resumed["step"]) == (6, 8) and resumed["all_finite"]
    assert saved == [4, 6, 8, 8]
    state = torch.load(checkpoint_file(run, TRAIN_STATE_FILE), weights_only=True)
    assert state["step"] == 8
    assert all(int(slots["step"]) == 8 for slots in state["opt_g"]["state"].values())


def test_a_run_of_one_step_a_call_resumes_with_two(tmp_path):
    """A run of one step a call (host-float learning rate) resumes with
    ``--steps_per_call 2`` (a tensor learning rate): from step 2 to 4, with
    Adam's step count going on from the saved one."""
    run = tmp_path / "k1"
    first = train_main(_spc_argv(run, 2, 1))
    assert first["step"] == 2
    resumed = train_main(_spc_argv(run, 4, 2) + ["--resume"])
    assert (resumed["start_step"], resumed["step"]) == (2, 4) and resumed["all_finite"]
    state = torch.load(checkpoint_file(run, TRAIN_STATE_FILE), weights_only=True)
    for opt in ("opt_g", "opt_d"):
        assert all(int(slots["step"]) == 4 for slots in state[opt]["state"].values())
        assert torch.is_tensor(state[opt]["param_groups"][0]["lr"])


# ---- data parallel: two ranks over gloo ----------------------------------- #

# one rank of the CLI under a 2-rank group (argv: the job directory, the rank):
# it records the paths it opens for writing, the streams it opens (mode, seed,
# batch) and the model's state at each checkpoint call
CLI_WORKER = textwrap.dedent(
    """
    import builtins, json, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    import video_prediction_torch.data as data
    from video_prediction_torch.parallel.distributed import maybe_initialize
    from video_prediction_torch.train import checkpoint
    from video_prediction_torch.train.__main__ import main

    path, rank = sys.argv[1], int(sys.argv[2])
    with open(f"{path}/argv.json") as f:
        argv = json.load(f)
    written, streams, states = [], [], []
    real_open, real_save = builtins.open, torch.save
    real_get, real_state = data.get_dataset_class, checkpoint.save_train_state

    def spy_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wxa+"):
            written.append(str(file))
        return real_open(file, mode, *args, **kwargs)

    def spy_save(obj, f, *args, **kwargs):
        written.append(str(f))
        return real_save(obj, f, *args, **kwargs)

    def spy_get(name):
        class Spy(real_get(name)):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                self.spied = (kwargs["mode"], kwargs["seed"])

            def make_iterator(self, batch_size, *args, **kwargs):
                streams.append((*self.spied, batch_size))
                return super().make_iterator(batch_size, *args, **kwargs)
        return Spy

    def spy_state(run_dir, ts):
        states.append({k: v.detach().clone() for k, v in ts.model.state_dict().items()})
        return real_state(run_dir, ts)

    builtins.open, torch.save = spy_open, spy_save
    data.get_dataset_class, checkpoint.save_train_state = spy_get, spy_state
    assert maybe_initialize(f"file://{path}/rendezvous", 2, rank, device="cpu")
    try:
        summary = main(argv)
    finally:
        dist.destroy_process_group()
        builtins.open, torch.save = real_open, real_save
    out = {"summary": summary, "written": written, "streams": streams, "state": states[-1]}
    torch.save(out, f"{path}/rank{rank}.pt")
    """
)


def test_two_ranks_write_from_rank_0_seed_their_streams_and_resume_across_world_sizes(tmp_path):
    """A world-1 run of 2 steps, resumed by 2 ranks (gloo, ``--steps_per_call
    2``, global ``--batch_size 2``) to 4 with the summaries, a GIF and an eval
    firing, resumed again by one process to 5: only rank 0 writes (the option
    files, one event file, the checkpoints); rank r reads train and val
    streams of one example seeded ``--seed`` + r; both ranks end with the same
    parameters, ``u``s and scalars, and the world-1 resume restores rank 0's
    state."""
    from test_torch_parallel import spawn

    run = tmp_path / "run"
    first = _train(run, 2)
    assert first["step"] == 2
    argv = ["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(ZOO), "--model_hparams", SMALL,
            "--output_dir", str(run), "--max_steps", "4", "--batch_size", "2", "--device", "cpu", "--resume",
            "--seed", str(SEED), "--steps_per_call", "2", "--progress_freq", "2", "--summary_freq", "2",
            "--image_summary_freq", "4", "--eval_summary_freq", "4", "--save_freq", "2"]
    (tmp_path / "argv.json").write_text(json.dumps(argv))
    events_before = sorted(run.glob("events.out.tfevents.*"))
    spawn(CLI_WORKER, tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]

    for r, out in enumerate(ranks):
        assert (out["summary"]["start_step"], out["summary"]["step"]) == (2, 4) and out["summary"]["all_finite"]
        assert sorted(out["streams"]) == [("train", SEED + r, 1), ("val", SEED + r, 1)]
    assert ranks[0]["summary"]["scalars"] == ranks[1]["summary"]["scalars"]
    assert "eval/psnr" in ranks[0]["summary"]["summaries"]
    assert not [p for p in ranks[1]["written"] if p.startswith(str(run))], ranks[1]["written"]
    names = {os.path.basename(p) for p in ranks[0]["written"]}
    assert {"options.json", "model_hparams.json", "dataset_hparams.json", TRAIN_STATE_FILE, PARAMS_FILE} <= names, names
    # each checkpoint file into a step's .tmp directory, renamed into place when whole
    assert {os.path.basename(os.path.dirname(p)) for p in ranks[0]["written"]
            if os.path.basename(p) in (TRAIN_STATE_FILE, PARAMS_FILE)} == {"4.tmp"}, ranks[0]["written"]
    events = sorted(run.glob("events.out.tfevents.*"))
    assert len(events) == len(events_before) + 1
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    saved = torch.load(checkpoint_file(run, TRAIN_STATE_FILE), weights_only=True)
    assert saved["step"] == 4
    for k, v in ranks[0]["state"].items():
        assert torch.equal(saved["model"][k], v), k

    resumed = _train(run, 5, resume=True)
    assert (resumed["start_step"], resumed["step"]) == (4, 5) and resumed["all_finite"]

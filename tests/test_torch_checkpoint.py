"""The port's checkpoints (``video_prediction_torch/train/checkpoint.py``) as
the JAX package's ``CheckpointManager`` keeps them
(``video_prediction_tpu/train/checkpoint.py``: one directory a step, the
newest three): retention after five saves; a step already kept is not
written again; a killed save's ``.tmp`` directory is ignored by the readers
and removed by the next save; ``step=`` restores an older kept step bit for
bit; the flat layout of a run directory written before step directories
still reads; the train CLI killed with SIGKILL between two saves resumes
from the newest whole step; ``generate`` and ``evaluate`` read the newest
step or ``--checkpoint_step``; the converter refuses to write over a kept
step; and under two gloo ranks rank 0 writes and every rank returns after
the step is whole. Small shapes, as ``tests/test_torch_train_cli.py``."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from video_prediction_torch import evaluate, generate
from video_prediction_torch.configs.hparams import DatasetHparams
from video_prediction_torch.models import get_model_class
from video_prediction_torch.train import checkpoint as C
from video_prediction_torch.train.__main__ import main as train_main
from video_prediction_torch.train.state import create_train_state
from video_prediction_torch.train.step import make_train_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ZOO = REPO / "hparams" / "bair_action_free" / "ours_savp" / "model_hparams.json"
SMALL = "ngf=4,nef=8,ndf=4,nz=4,sequence_length=5,clip_length=4"
SEED = 3
KILL_TIMEOUT = 300  # seconds for the killed run to reach its save


def _model(size=32):
    from video_prediction_torch.configs.hparams import apply_overrides, load_hparams_json, parse_overrides

    hp = apply_overrides(get_model_class("savp").default_hparams(), load_hparams_json(str(ZOO)))
    hp = apply_overrides(hp, parse_overrides(SMALL))
    return get_model_class("savp")(hp, image_shape=(size, size, 3), action_dim=4)


def _state(step, seed=SEED, size=32):
    """A train state at ``step`` whose weights and generator come from ``seed``
    (``size`` px images; the train CLI's synthetic clips are 64 px)."""
    ts = create_train_state(_model(size), seed, "cpu")
    ts.step = step
    return ts


def _same_state(a, b):
    """Two train states with the same step, model, Adam slots and generator."""
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for oa, ob in ((a.opt_g, b.opt_g), (a.opt_d, b.opt_d)):
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            assert sorted(oa.state[pa]) == sorted(ob.state[pb])
            assert all(torch.equal(oa.state[pa][k], ob.state[pb][k]) for k in oa.state[pa])
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Five saves of a state stepped on by one train step each (steps 1-5),
    the state after each save kept for comparison."""
    run = tmp_path_factory.mktemp("ckpt") / "run"
    ts = _state(0)
    step = make_train_step(ts.model)
    batch = {"images": torch.randint(0, 256, (2, 5, 32, 32, 3), generator=torch.Generator().manual_seed(0),
                                     dtype=torch.uint8),
             "actions": torch.zeros(2, 5, 4)}
    states, wrote = {}, []
    for _ in range(5):
        step(ts, batch)
        wrote.append(C.save_train_state(str(run), ts))
        states[ts.step] = {k: v.clone() for k, v in ts.model.state_dict().items()}
    return run, ts, states, wrote


def test_five_saves_keep_the_newest_three(trained):
    run, ts, _, wrote = trained
    assert wrote == [True] * 5
    assert C.kept_steps(str(run)) == [3, 4, 5] and C.latest_step(str(run)) == 5
    assert sorted(os.listdir(run / C.CHECKPOINT_DIR)) == ["3", "4", "5"]
    for s in (3, 4, 5):
        assert sorted(os.listdir(run / C.CHECKPOINT_DIR / str(s))) == [C.PARAMS_FILE, C.TRAIN_STATE_FILE]
    assert C.MAX_TO_KEEP == 3


def test_a_kept_step_is_not_written_again(trained):
    run, ts, _, _ = trained
    path = C.checkpoint_file(str(run), C.TRAIN_STATE_FILE, 5)
    before = os.stat(path).st_mtime_ns, open(path, "rb").read()
    ts5 = _state(5, seed=SEED + 1)  # other weights at the kept step
    assert C.save_train_state(str(run), ts5) is False
    assert (os.stat(path).st_mtime_ns, open(path, "rb").read()) == before
    assert C.kept_steps(str(run)) == [3, 4, 5]


def test_the_newest_and_an_older_step_restore_bit_for_bit(trained):
    run, ts, states, _ = trained
    newest = _state(0, seed=SEED + 2)
    C.load_train_state(str(run), newest)
    _same_state(newest, ts)
    for s in (3, 4):
        older = _state(0, seed=SEED + 2)
        C.load_train_state(str(run), older, step=s)
        assert older.step == s
        assert all(torch.equal(v, states[s][k]) for k, v in older.model.state_dict().items())
        model = _model()
        assert C.load_params(str(run), model, step=s) == s
        assert all(torch.equal(v, states[s][k]) for k, v in model.state_dict().items())
    assert C.load_params(str(run), _model()) == 5
    with pytest.raises(FileNotFoundError, match="step 2"):
        C.load_train_state(str(run), _state(0), step=2)  # pruned


def test_a_killed_saves_tmp_is_ignored_then_removed(tmp_path):
    run = tmp_path / "run"
    C.save_train_state(str(run), _state(1))
    tmp = run / C.CHECKPOINT_DIR / ("2" + C.TMP_SUFFIX)
    tmp.mkdir()
    (tmp / C.TRAIN_STATE_FILE).write_bytes(b"PK\x03\x04 cut short")  # what a kill mid-write leaves
    assert C.kept_steps(str(run)) == [1] and C.latest_step(str(run)) == 1 and C.has_train_state(str(run))
    restored = _state(0, seed=SEED + 1)
    C.load_train_state(str(run), restored)
    assert restored.step == 1
    with pytest.raises(FileNotFoundError):
        C.checkpoint_file(str(run), C.TRAIN_STATE_FILE, 2)
    assert C.save_train_state(str(run), _state(2)) is True  # the same step, written afresh
    assert sorted(os.listdir(run / C.CHECKPOINT_DIR)) == ["1", "2"]
    stale = run / C.CHECKPOINT_DIR / ("9" + C.TMP_SUFFIX)
    stale.mkdir()
    C.save_train_state(str(run), _state(3))
    assert sorted(os.listdir(run / C.CHECKPOINT_DIR)) == ["1", "2", "3"]


def test_the_flat_layout_reads_as_its_one_step(trained, tmp_path):
    """A run directory written before step directories: its two files under
    ``checkpoints/`` read as the step its train state holds; a params-only
    one reads without a step; a save beside them becomes the newest step."""
    run, ts, _, _ = trained
    flat = tmp_path / "flat"
    (flat / C.CHECKPOINT_DIR).mkdir(parents=True)
    for name in (C.TRAIN_STATE_FILE, C.PARAMS_FILE):
        (flat / C.CHECKPOINT_DIR / name).write_bytes(Path(C.checkpoint_file(str(run), name)).read_bytes())
    assert C.kept_steps(str(flat)) == [] and C.latest_step(str(flat)) == 5 and C.has_train_state(str(flat))
    restored = _state(0, seed=SEED + 1)
    C.load_train_state(str(flat), restored)
    _same_state(restored, ts)
    C.load_train_state(str(flat), _state(0), step=5)
    with pytest.raises(FileNotFoundError):
        C.load_train_state(str(flat), _state(0), step=4)
    assert C.load_params(str(flat), _model()) == 5
    params_only = tmp_path / "params_only"
    (params_only / C.CHECKPOINT_DIR).mkdir(parents=True)
    (params_only / C.CHECKPOINT_DIR / C.PARAMS_FILE).write_bytes((flat / C.CHECKPOINT_DIR / C.PARAMS_FILE).read_bytes())
    assert C.latest_step(str(params_only)) is None and not C.has_train_state(str(params_only))
    assert C.load_params(str(params_only), _model()) is None
    assert C.save_train_state(str(flat), _state(6)) and C.latest_step(str(flat)) == 6
    assert (flat / C.CHECKPOINT_DIR / C.TRAIN_STATE_FILE).is_file()  # left as it was, no longer read
    assert C.load_params(str(flat), _model()) == 6


def test_an_empty_run_dir_has_no_checkpoint(tmp_path):
    assert C.kept_steps(str(tmp_path)) == [] and C.latest_step(str(tmp_path)) is None
    assert not C.has_train_state(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        C.load_params(str(tmp_path), _model())


def _argv(run_dir, steps, extra=()):
    return ["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(ZOO), "--model_hparams", SMALL,
            "--output_dir", str(run_dir), "--max_steps", str(steps), "--batch_size", "2", "--device", "cpu",
            "--progress_freq", "1", "--seed", str(SEED), "--no_tensorboard", *extra]


def test_train_keeps_three_steps_and_skips_the_final_save_of_a_kept_step(tmp_path, capsys, monkeypatch):
    """``--save_freq 1`` for 4 steps: steps 2-4 kept; the final save at step
    4, after the periodic one, writes nothing (``scripts/train.py:329-333``);
    ``--resume`` restores the newest kept step."""
    wrote = []
    save = C.save_train_state
    monkeypatch.setattr(C, "save_train_state", lambda run_dir, ts: wrote.append((ts.step, save(run_dir, ts))))
    out = train_main(_argv(tmp_path / "run", 4, ["--save_freq", "1"]))
    assert out["step"] == 4 and wrote == [(1, True), (2, True), (3, True), (4, True), (4, False)]
    assert C.kept_steps(str(tmp_path / "run")) == [2, 3, 4]
    out = train_main(_argv(tmp_path / "run", 5, ["--save_freq", "1", "--resume"]))
    assert "resumed from step 4" in capsys.readouterr().out and (out["start_step"], out["step"]) == (4, 5)
    assert C.kept_steps(str(tmp_path / "run")) == [3, 4, 5]


def test_generate_and_evaluate_read_the_newest_or_a_given_step(tmp_path, capsys):
    run = tmp_path / "run"
    train_main(_argv(run, 3, ["--save_freq", "1"]))
    capsys.readouterr()
    flags = ["--checkpoint", str(run), "--device", "cpu", "--batch_size", "2", "--num_samples", "2"]
    for extra, want in (([], 3), (["--checkpoint_step", "1"], 1)):
        gen = generate.main(flags + ["--results_dir", str(tmp_path / f"gen{want}"), *extra])
        assert gen["step"] == want and gen["all_finite"]
        ev = evaluate.main(flags + ["--results_dir", str(tmp_path / f"eval{want}"), "--num_stochastic_samples", "2",
                                    *extra])
        assert ev["step"] == want and ev["no_nan"]
        assert capsys.readouterr().out.count(f"restored step {want} from {run}") == 2
    with pytest.raises(FileNotFoundError, match="step 7"):
        generate.main(flags + ["--results_dir", str(tmp_path / "gen7"), "--checkpoint_step", "7"])


def test_write_run_dir_writes_params_as_step_0(tmp_path):
    model = _model()
    C.write_run_dir(str(tmp_path), "savp", "synthetic", model.hparams, DatasetHparams(sequence_length=5), model)
    assert C.kept_steps(str(tmp_path)) == [0] and not C.has_train_state(str(tmp_path))
    assert C.load_params(str(tmp_path), _model()) == 0


def test_the_train_cli_killed_between_saves_resumes_from_the_newest_whole_step(tmp_path):
    """``python -m video_prediction_torch.train --save_freq 1`` killed with
    SIGKILL once step 1 is kept, while it trains step 2 or later: the newest
    kept step is whole and restores, and ``--resume`` goes on from it."""
    run = tmp_path / "run"
    argv = _argv(run, 1000, ["--save_freq", "1"])
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")}
    env["OMP_NUM_THREADS"] = "1"  # as this process's torch.set_num_threads(1)
    with open(tmp_path / "log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "video_prediction_torch.train", *argv], cwd=REPO, env=env,
                                stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + KILL_TIMEOUT
            while not C.kept_steps(str(run)) and proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
    assert proc.returncode == -signal.SIGKILL, (tmp_path / "log").read_text()[-3000:]
    newest = C.latest_step(str(run))
    assert newest is not None, (tmp_path / "log").read_text()[-3000:]
    restored = _state(0, size=64)
    C.load_train_state(str(run), restored)
    assert restored.step == newest
    out = train_main(_argv(run, newest + 1, ["--save_freq", "1", "--resume"]))
    assert (out["start_step"], out["step"]) == (newest, newest + 1) and out["all_finite"]
    assert C.latest_step(str(run)) == newest + 1
    assert not [d for d in os.listdir(run / C.CHECKPOINT_DIR) if d.endswith(C.TMP_SUFFIX)]


def test_convert_refuses_to_write_over_a_kept_step(tmp_path):
    from video_prediction_torch.convert import convert_run

    export = REPO / "tests" / "fixtures" / "jax_run_small"
    out = convert_run(str(export), str(tmp_path / "port"))
    assert C.kept_steps(str(tmp_path / "port")) == [out["step"]]
    assert sorted(out["bytes"]) == sorted([C.PARAMS_FILE, C.TRAIN_STATE_FILE, "jax_train_state.npz"])
    with pytest.raises(FileExistsError, match=f"step {out['step']}"):
        convert_run(str(export), str(tmp_path / "port"))


# one rank of two over gloo (argv: the job directory, the rank): five saves of
# steps 1-4 and 4 again, what each returned, whether the step was whole when
# it returned, and the files it opened for writing
SAVE_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from video_prediction_torch.parallel.distributed import maybe_initialize
    from video_prediction_torch.train import checkpoint as C
    from video_prediction_torch.train.state import TrainState

    path, rank = sys.argv[1], int(sys.argv[2])
    written, real_save = [], torch.save

    def spy_save(obj, f, *args, **kwargs):
        written.append(str(f))
        return real_save(obj, f, *args, **kwargs)

    torch.save = spy_save
    assert maybe_initialize(f"file://{path}/rendezvous", 2, rank, device="cpu")
    try:
        model = torch.nn.Linear(3, 2)
        torch.nn.init.constant_(model.weight, 0.5)
        opt = torch.optim.Adam(model.parameters())
        run, out = f"{path}/run", []
        for step in (1, 2, 3, 4, 4):
            ts = TrainState(model, opt, None, step, torch.Generator().manual_seed(step))
            wrote = C.save_train_state(run, ts)
            d = os.path.join(run, C.CHECKPOINT_DIR, str(step))
            whole = all(os.path.isfile(os.path.join(d, f)) for f in (C.PARAMS_FILE, C.TRAIN_STATE_FILE))
            out.append([step, wrote, whole, C.kept_steps(run)])
    finally:
        dist.destroy_process_group()
        torch.save = real_save
    with open(f"{path}/rank{rank}.json", "w") as f:
        json.dump({"saves": out, "written": written}, f)
    """
)


def test_rank_0_writes_and_every_rank_waits_for_the_whole_step(tmp_path):
    from test_torch_parallel import spawn

    spawn(SAVE_WORKER, tmp_path)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    want = [[1, True, True, [1]], [2, True, True, [1, 2]], [3, True, True, [1, 2, 3]], [4, True, True, [2, 3, 4]],
            [4, False, True, [2, 3, 4]]]
    assert ranks[0]["saves"] == ranks[1]["saves"] == want
    assert ranks[1]["written"] == []
    assert sorted({os.path.basename(os.path.dirname(p)) for p in ranks[0]["written"]}) == ["1.tmp", "2.tmp", "3.tmp",
                                                                                           "4.tmp"]
    assert len(ranks[0]["written"]) == 8

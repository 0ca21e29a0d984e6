"""Spatial partitioning in the port (``parallel/mesh.py#make_spatial_mesh``,
``parallel/spatial.py``, the spatially sharded layers, ``train/step.py``'s
``spatial``, the train CLI's ``--spatial_shards``) on the CPU over gloo:

- ``validate_spatial_mesh``'s accepts and refusals against the JAX
  function's, and ``shard_batch``'s split of the leaves;
- each collective against its definition, and each sharded layer against
  the same layer on the whole image, forward and backward (the backward
  against autograd of the unsharded expression), in 2 and 4 spawned ranks;
- the train step at dp1 x sp2 (2 ranks) and dp2 x sp2 (4 ranks) against the
  JAX package's step on ``make_mesh(devices[:2 or 4], model_parallel=2)``
  and against the port's one-process step, from the same weights and noise;
  a bf16 merged-gate config; every generator option against the port's
  one-process step; the eval step against the JAX spatial eval step;
  ``steps_per_call=3`` against three single steps;
- the CLI under two ranks, and ``--spatial_shards 2`` in one process.

Small shapes, as ``ROADMAP.md``'s rules for port tests ask: 32 px (2
scales, an 8-row bottleneck, 4 rows a shard at k = 2), ngf=4, nef=8, nz=4,
6 frames; the JAX side with ``scan_unroll=1``, its weights seeded
(``tests/test_torch_objectives.py#_seeded``) and its batch a jit argument."""

import concurrent.futures
import copy
import json
import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_objectives import _seeded, vgg_path  # noqa: F401 (a fixture)
from test_torch_parallel import GRAD_FLOOR, GRAD_TOL, LOSS_RTOL, _jax_noise, one_rank_group, spawn  # noqa: F401

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.models import input_dims
from video_prediction_torch.ops import layers as tlayers
from video_prediction_torch.parallel.mesh import (
    SpatialMesh,
    image_rows,
    make_spatial_mesh,
    shard_batch,
    spatial_context,
    validate_spatial_mesh,
)
from video_prediction_torch.train.state import TrainState, make_optimizers
from video_prediction_torch.train.step import make_eval_step, make_train_step
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.parallel import mesh as jmesh
from video_prediction_tpu.train import make_eval_step as j_make_eval_step
from video_prediction_tpu.train import make_train_step as j_make_train_step
from video_prediction_tpu.train.state import TrainState as JTrainState
from video_prediction_tpu.train.state import make_optimizers as j_make_optimizers
from video_prediction_tpu.train.state import split_params as j_split_params

torch.set_num_threads(1)

# scan_unroll=1 on both sides: the same (concat) form of the dependent mask head
SMALL = dict(ngf=4, nef=8, ndf=4, nz=4, sequence_length=6, clip_length=4, kl_anneal_steps=(0, 2),
             schedule_sampling_k=2.0, batch_size=2, scan_unroll=1)
B, T, SIZE = 2, 6, 32
FLAGSHIP = "bair_action_free/ours_savp"
BF16 = "synthetic/ours_savp"  # bf16 compute, fp32 gates, merged gate convs
LAYER_ATOL, LAYER_RTOL = 2e-5, 1e-4  # a sharded layer against the whole one: sums in other orders
PARAM_ATOL = 5e-5  # after Adam's first step where settled (tests/test_model_train.py:307-310)
# bf16, sharded against whole: each leaf within BF16_GRAD_RATIO times the
# whole bf16 step's distance from its fp32 step plus one bf16 rounding of the
# leaf's largest fp32 entry (tests/test_torch_bf16.py's rule for the port
# against JAX); each loss term within BF16_RATIO times it
BF16_GRAD_RATIO, BF16_RATIO, BF16_ULP = 4.0, 2.0, 2.0**-8
MULTI_K = 3
# every generator option, and the zoo files whose options the flagship lacks,
# each one parametrised case against the port's one-process step: (model,
# zoo file, overrides); ``vgg_cdist_weight`` takes seeded VGG16 weights
OPTIONS = {
    "dna": ("savp", FLAGSHIP, dict(transformation="dna")),
    "stp": ("savp", FLAGSHIP, dict(transformation="stp")),
    "flow": ("savp", FLAGSHIP, dict(transformation="flow")),
    "deconv2d": ("savp", FLAGSHIP, dict(upsample_layer="deconv2d")),
    "bilinear_conv2d": ("savp", FLAGSHIP, dict(upsample_layer="bilinear_conv2d")),
    "max_pool_conv2d": ("savp", FLAGSHIP, dict(downsample_layer="max_pool_conv2d")),
    "conv2d_downsample": ("savp", FLAGSHIP, dict(downsample_layer="conv2d")),
    "learn_initial_state": ("savp", FLAGSHIP, dict(learn_initial_state=True)),
    "learn_prior": ("savp", FLAGSHIP, dict(learn_prior=True)),
    "image_acvideo_gan": ("savp", FLAGSHIP, dict(image_sn_gan_weight=0.1, image_sn_vae_gan_weight=0.1,
                                                 acvideo_sn_gan_weight=0.1)),
    "z_l1": ("savp", FLAGSHIP, dict(z_l1_weight=1.0)),
    "tv": ("savp", FLAGSHIP, dict(tv_weight=0.01)),
    "vgg_cdist": ("savp", FLAGSHIP, dict(vgg_cdist_weight=1.0)),
    "gru": ("savp", FLAGSHIP, dict(conv_rnn="gru")),
    "bair/dna_l2": ("dna", "bair/dna_l2", {}),
    "bair/sna_l2": ("sna", "bair/sna_l2", {}),
    "sv2p": ("sv2p", "bair_action_free/sv2p", {}),
    "ours_deterministic_l1": ("savp", "bair_action_free/ours_deterministic_l1", {}),
}


# ---------------------------------------------------------------------------
# validate_spatial_mesh, shard_batch, the mesh in one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("size", [32, 64, 128, 256])
def test_validate_spatial_mesh_matches_jax(size, k):
    """The same accepts, and the same refusal, as the JAX function on a
    ``make_mesh(model_parallel=k)`` mesh of the conftest's virtual devices."""
    mesh = jmesh.make_mesh(jax.devices()[:k], model_parallel=k)
    try:
        jmesh.validate_spatial_mesh(mesh, size, size)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        validate_spatial_mesh(k, size, size)
    else:
        with pytest.raises(ValueError) as got:
            validate_spatial_mesh(k, size, size)
        assert str(got.value) == want


@pytest.mark.parametrize("stacked", [False, True], ids=["batch", "stacked"])
def test_shard_batch_splits_images_by_rows_and_keeps_low_dim_leaves(stacked):
    """dp2 x sp2: the images split by sample (data coordinate) and by rows
    (spatial coordinate), dim 2 or 3 when stacked (``leaf_spec``'s ``P("data",
    None, "model")``); ``actions`` split by sample only, whole in the spatial
    group (``test_low_dim_leaves_stay_batch_sharded``)."""
    rng = np.random.RandomState(0)
    lead = (3,) if stacked else ()
    batch = {"images": rng.randint(0, 255, lead + (4, 6, 8, 8, 3)).astype(np.uint8),
             "actions": torch.from_numpy(rng.randn(*lead, 4, 6, 4).astype(np.float32))}
    b_dim, h_dim = (1, 3) if stacked else (0, 2)
    shards = {(d, c): shard_batch(batch, d, 2, stacked, spatial=(c, 2)) for d in range(2) for c in range(2)}
    assert shards[1, 0]["images"].shape[b_dim] == 2 and shards[1, 0]["images"].shape[h_dim] == 4
    rows = [np.concatenate([shards[d, c]["images"] for c in range(2)], axis=h_dim) for d in range(2)]
    np.testing.assert_array_equal(np.concatenate(rows, axis=b_dim), batch["images"])
    for d in range(2):
        assert torch.equal(shards[d, 0]["actions"], shards[d, 1]["actions"])
        assert torch.equal(shards[d, 0]["actions"], shard_batch(batch, d, 2, stacked)["actions"])
    np.testing.assert_array_equal(image_rows(batch, 1, 2, stacked)["images"],
                                  np.split(batch["images"], 2, axis=h_dim)[1])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(batch, 0, 2, stacked, spatial=(0, 3))


@pytest.mark.parametrize("stack", [1, 2])
def test_device_feeder_sends_this_ranks_image_rows(stack):
    """``DeviceFeeder(rows=(coord, k))`` cuts each host batch's images to the
    rank's slice of H (stacked or not) and leaves the low-dim leaves whole."""
    from video_prediction_torch.data import DeviceFeeder

    host = _host_batch()[:2]
    feeder = DeviceFeeder(iter(host), "cpu", stack=stack, rows=(1, 2))
    try:
        got = next(feeder)
    finally:
        feeder.close()
    want = {k: np.stack([h[k] for h in host]) if stack > 1 else host[0][k] for k in host[0]}
    np.testing.assert_array_equal(got["images"].numpy(), np.split(want["images"], 2, axis=-3)[1])
    for key in ("actions", "states"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])


def test_spatial_mesh_in_one_process():
    """``--spatial_shards 1`` is no mesh; more shards than ranks raise, as
    ``mesh_for_batch`` raises on one device."""
    assert make_spatial_mesh(1) is None
    for k in (2, 0):
        with pytest.raises(ValueError, match=f"1 ranks not divisible by spatial_shards={k}"):
            make_spatial_mesh(k)


def test_exact_schedule_sampling_needs_a_data_size_of_one(one_rank_group):
    """``schedule_sampling_exact`` counts ground-truth samples over the whole
    batch, which needs no data size of one: at dp1 x sp2 a spatial group sees
    all of its samples, and at dp2 x sp2 each data coordinate's mask is its
    columns of the global batch's, alike on the ranks of its spatial group
    (``_rank_noise`` ranks the global uniforms), so both take it; a spatial
    mesh without the group it divides is refused."""
    from video_prediction_torch.train import schedules
    from video_prediction_torch.train.step import _rank_noise

    model = _model(_port_hparams(schedule_sampling_exact=True), {k: torch.from_numpy(v) for k, v in
                                                                 _host_batch()[0].items()})
    for k in (1, MULTI_K):
        make_train_step(model, k, group=one_rank_group, spatial=SpatialMesh(2, 0, 0, 1, None))
        make_train_step(model, k, group=one_rank_group, spatial=SpatialMesh(2, 0, 1, 2, None))
    hp = model.hparams
    t = hp.sequence_length
    ts = TrainState(model, None, None, 0, torch.Generator())
    noise = model.draw_noise(4, t, torch.Generator().manual_seed(1))
    whole = schedules.sample_use_gt_mask(4, t, hp, True, step=0, uniforms=noise["use_gt_u"])
    columns = []
    for data_rank in range(2):
        masks = []
        for coord in range(2):
            mine = _rank_noise(ts, torch.zeros(2, t, 16, 32, 3), noise, one_rank_group,
                               SpatialMesh(2, coord, data_rank, 2, None))
            masks.append(schedules.sample_use_gt_mask(2, t, hp, True, step=0, uniforms=mine["use_gt_u"],
                                                      ranks=mine["use_gt_rank"], total=mine["use_gt_batch"]))
        assert torch.equal(masks[0], masks[1])
        columns.append(masks[0])
    assert torch.equal(torch.cat(columns, dim=1), whole)
    with pytest.raises(ValueError, match="needs the process group"):
        make_train_step(model, spatial=SpatialMesh(2, 0, 0, 1, None))


@pytest.mark.parametrize("layer", ["Conv3D", "Local2D", "SeparableLocal2D"])
def test_layers_without_a_sharded_form_raise_on_a_shard(layer):
    """The layers no generator uses have no sharded form: under a spatial
    context they raise before any collective."""
    build, x = {
        "Conv3D": (lambda: tlayers.Conv3D(3, 4), torch.zeros(1, 2, 4, 4, 3)),
        "Local2D": (lambda: tlayers.Local2D(4, 4, 3, 4), torch.zeros(1, 4, 4, 3)),
        "SeparableLocal2D": (lambda: tlayers.SeparableLocal2D(4, 4, 3), torch.zeros(1, 4, 4, 3)),
    }[layer]
    module = build()
    with spatial_context(SpatialMesh(2, 0, 0, 1, None)), pytest.raises(ValueError, match="no spatially sharded form"):
        module(x)


# ---------------------------------------------------------------------------
# the collectives and the sharded layers, in 2 and 4 ranks
# ---------------------------------------------------------------------------

# ``case(name)`` -> (fn, module, inputs, input row dims, output row dim):
# ``fn`` runs on this rank's rows of the inputs (row dim None: whole on every
# rank) under a spatial context, and on the whole inputs outside one; an
# output row dim of None is an output whole on every rank; ``module`` (or
# None) holds the parameters whose gradients are compared. ``reference(name, out, rank, k)``
# is rank ``rank``'s share of the unsharded output ``out`` where ``fn``
# outside a context is not the definition (the collectives themselves).
CASES = textwrap.dedent(
    """
    import torch
    import torch.nn.functional as F
    from video_prediction_torch.ops import cdna, layers, rnn, warp
    from video_prediction_torch.parallel import spatial as SP
    from video_prediction_torch.parallel.mesh import current_spatial

    NAMES = ["halo_zeros", "halo_edge", "all_reduce_sum", "gather_rows", "take_rows", "mean_hw", "conv3",
             "conv5", "conv3_stride2", "conv4_stride2", "deconv", "upsample_nearest", "upsample_bilinear",
             "conv_pool_avg", "conv_pool_max", "instance_norm", "group_norm", "lstm_split", "lstm_merged", "gru",
             "cdna", "dna", "stp", "flow"]
    SHAPE = (2, 16, 8, 3)  # B, H, W, C: 8 rows a shard in 2 ranks, 4 in 4

    def _x(seed, *shape):
        return torch.randn(shape or SHAPE, generator=torch.Generator().manual_seed(seed))

    def _layer(module, seed):
        m = module()
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():  # weights lecun-scaled, norm scales and biases off their init
            for name, p in m.named_parameters():
                if name.endswith("weight"):
                    p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5)
                else:
                    p.add_(0.3 * torch.randn(p.shape, generator=gen))
        return m

    def case(name):
        seed = NAMES.index(name) * 10
        mesh = current_spatial
        if name.startswith("halo"):
            edge = name == "halo_edge"
            return (lambda x: SP.halo(x, mesh(), 2, 1, edge=edge) if mesh() else x), None, [_x(seed)], [1], 1
        if name == "all_reduce_sum":
            return (lambda x: SP.all_reduce_sum(x, mesh()) if mesh() else x), None, [_x(seed)], [1], 1
        if name == "gather_rows":
            return (lambda x: SP.gather_rows(x, mesh()) if mesh() else x), None, [_x(seed)], [1], None
        if name == "take_rows":
            return (lambda x: SP.take_rows(x, mesh()) if mesh() else x), None, [_x(seed)], [None], 1
        if name == "mean_hw":
            return SP.mean_hw, None, [_x(seed)], [1], None
        modules = {
            "conv3": lambda: layers.Conv2D(3, 5, 3),
            "conv5": lambda: layers.Conv2D(3, 4, 5),
            "conv3_stride2": lambda: layers.Conv2D(3, 4, 3, strides=2),
            "conv4_stride2": lambda: layers.Conv2D(3, 4, 4, strides=2),
            "deconv": lambda: layers.ConvTranspose2D(3, 4),
            "upsample_nearest": lambda: layers.UpsampleConv2D(3, 4),
            "upsample_bilinear": lambda: layers.UpsampleConv2D(3, 4, method="bilinear"),
            "conv_pool_avg": lambda: layers.ConvPool2D(3, 4),
            "conv_pool_max": lambda: layers.ConvPool2D(3, 4, pool_mode="max"),
            "instance_norm": lambda: layers.InstanceNorm(3),
            "group_norm": lambda: layers.GroupNorm(4, 2),
        }
        if name in modules:
            m = _layer(modules[name], seed)
            x = _x(seed, 2, 16, 8, 4) if name == "group_norm" else _x(seed)
            return m, m, [x], [1], 1
        if name == "gru":
            cell = _layer(lambda: rnn.ConvGRUCell(3, 4), seed)
            return (lambda h, x: cell(h, x)[0]), cell, [_x(seed + 2, 2, 16, 8, 4), _x(seed + 3)], [1, 1], 1
        if name.startswith("lstm"):
            cell = _layer(lambda: rnn.ConvLSTMCell(3, 4, use_norm=True, gate_conv=name[5:]), seed)
            return ((lambda c, h, x: torch.cat(cell((c, h), x)[0], -1)), cell,
                    [_x(seed + 2, 2, 16, 8, 4), _x(seed + 3, 2, 16, 8, 4), _x(seed + 4)], [1, 1, 1], 1)
        if name == "cdna":
            kern = cdna.normalize_kernels(_x(seed + 1, 2, 5, 5, 4))
            return cdna.apply_cdna_kernels, None, [_x(seed), kern], [1, None], 2
        if name == "dna":
            kern = cdna.normalize_kernels(_x(seed + 1, 2, 16, 8, 5, 5, 1))[..., 0]
            return cdna.apply_dna_kernels, None, [_x(seed), kern], [1, 1], 2
        if name == "stp":
            return warp.apply_affine_kernels, None, [_x(seed), 0.3 * _x(seed + 1, 2, 3, 6)], [1, None], 2
        if name == "flow":
            return warp.image_warp, None, [_x(seed), 3.0 * _x(seed + 1, 2, 16, 8, 2)], [1, 1], 1
        raise KeyError(name)

    def reference(name, out, rank, k):
        h = out.shape[1] // k
        if name.startswith("halo"):
            pad = (0, 0, 0, 0, 2, 1)
            full = (F.pad(out.permute(0, 3, 1, 2), pad[2:], mode="replicate").permute(0, 2, 3, 1)
                    if name == "halo_edge" else F.pad(out, pad))
            return full[:, rank * h: rank * h + h + 3]
        if name == "all_reduce_sum":
            return out.unflatten(1, (k, h)).sum(1)
        return None

    def params(module):
        return {} if module is None else dict(module.named_parameters())

    def upstream(shape, name, rank):
        return torch.randn(shape, generator=torch.Generator().manual_seed(1000 + 10 * NAMES.index(name) + rank))
    """
)

# one rank of the layer runs (argv: the job directory, the rank): every case,
# forward and backward on this rank's rows, under the group of all ranks
LAYER_WORKER = CASES + textwrap.dedent(
    """
    import json, sys
    import torch.distributed as dist
    torch.set_num_threads(1)
    from video_prediction_torch.parallel.distributed import maybe_initialize
    from video_prediction_torch.parallel.mesh import make_spatial_mesh, spatial_context

    path, rank = sys.argv[1], int(sys.argv[2])
    with open(f"{path}/job.json") as f:
        world = json.load(f)["world"]
    assert maybe_initialize(f"file://{path}/rendezvous", world, rank, device="cpu")
    try:
        mesh = make_spatial_mesh(world)
        out = {}
        for name in NAMES:
            fn, module, xs, dims, _ = case(name)
            xs = [(SP.take_rows(x, mesh, d) if d is not None else x).clone().requires_grad_() for x, d in zip(xs, dims)]
            with spatial_context(mesh):
                y = fn(*xs)
            (y * upstream(y.shape, name, rank)).sum().backward()
            out[name] = {"out": y.detach(), "grads": [x.grad for x in xs],
                         "params": {k: p.grad for k, p in params(module).items()}}
        torch.save(out, f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    """
)

_CASES: dict = {}
exec(CASES, _CASES)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def layer_runs(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(f"layers{request.param}")
    (path / "job.json").write_text(json.dumps({"world": request.param}))
    spawn(LAYER_WORKER, path, world=request.param)
    return request.param, [torch.load(path / f"rank{r}.pt", weights_only=False) for r in range(request.param)]


@pytest.mark.parametrize("name", _CASES["NAMES"])
def test_sharded_op_matches_the_whole(layer_runs, name):
    """Rank r's output against its share of the unsharded output (its rows,
    the whole for a gather or a pool, the definition for a halo and a sum);
    the input gradients put together (rows concatenated, whole inputs
    summed) and the parameter gradients summed over the ranks against
    autograd of the sum over the ranks of the same upstream gradients
    through the unsharded expression."""
    k, ranks = layer_runs
    fn, module, xs, dims, out_dim = _CASES["case"](name)
    xs = [x.clone().requires_grad_() for x in xs]
    whole = fn(*xs)
    loss = 0.0
    for r, got in enumerate(ranks):
        want = _CASES["reference"](name, whole, r, k)
        if want is None:
            want = whole if out_dim is None else whole.unflatten(out_dim, (k, -1)).select(out_dim, r)
        torch.testing.assert_close(got[name]["out"], want.detach(), atol=LAYER_ATOL, rtol=LAYER_RTOL,
                                   msg=lambda m: f"rank {r} output: {m}")
        loss = loss + (want * _CASES["upstream"](want.shape, name, r)).sum()
    params = _CASES["params"](module)
    grads = torch.autograd.grad(loss, xs + list(params.values()))
    for i, (g, d) in enumerate(zip(grads, dims)):
        parts = [got[name]["grads"][i] for got in ranks]
        got_g = sum(parts) if d is None else torch.cat(parts, d)
        torch.testing.assert_close(got_g, g, atol=LAYER_ATOL, rtol=LAYER_RTOL, msg=lambda m: f"input {i}: {m}")
    for (pname, _), g in zip(params.items(), grads[len(xs):]):
        torch.testing.assert_close(sum(got[name]["params"][pname] for got in ranks), g, atol=LAYER_ATOL,
                                   rtol=LAYER_RTOL, msg=lambda m: f"{pname}: {m}")


# ---------------------------------------------------------------------------
# the train step, the eval step, MultiStep: against JAX and one process
# ---------------------------------------------------------------------------


def _jax_hparams(zoo):
    path = jhp.zoo_dir() / zoo / "model_hparams.json"
    return jhp.resolve_model_hparams(j_get_model_class("savp").default_hparams(), str(path), extra=SMALL)


def _port_hparams(zoo=FLAGSHIP, model="savp", **extra):
    path = thp.zoo_dir() / zoo / "model_hparams.json"
    return thp.resolve_model_hparams(t_get_model_class(model).default_hparams(), str(path), extra={**SMALL, **extra})


def _host_batch():
    """MULTI_K batches of the synthetic stream (images, actions, states)."""
    it = SyntheticVideoDataset(mode="train", seed=0, image_size=SIZE).make_iterator(B)
    return [{k: v[:, :T] for k, v in next(it).items()} for _ in range(MULTI_K)]


def _jax_setup(zoo, host):
    """The JAX model of ``zoo`` at step 0 with seeded weights (no flax init),
    its batch, and the weights and spectral ``u``s as a port state dict."""
    jh = _jax_hparams(zoo)
    jmodel = j_get_model_class("savp")(jh, mode="train")
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    params, state = _seeded(jax.eval_shape(lambda b: jmodel.init_variables(jax.random.PRNGKey(0), b), jbatch), 7)
    params, state = jax.tree_util.tree_map(jnp.asarray, (params, state))
    tx_g, tx_d = j_make_optimizers(jh)
    pg, pd = j_split_params(params)
    ts = JTrainState(step=jnp.zeros((), jnp.int32), params=params, model_state=state, opt_state_g=tx_g.init(pg),
                     opt_state_d=tx_d.init(pd), rng=jax.random.PRNGKey(5))
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                            {"discriminator": jax.tree_util.tree_map(np.asarray, state["spectral"])})
    return {"model": jmodel, "ts": ts, "batch": jbatch, "state_dict": sd}


def _jax_step(setup, devices):
    """The JAX spatial step's scalars on ``make_mesh(devices[:n], model_parallel=2)``."""
    mesh = jmesh.make_mesh(jax.devices()[:devices], model_parallel=2)
    step = j_make_train_step(setup["model"], mesh=mesh, donate=False)
    _, scalars = step(setup["ts"], jmesh.shard_batch(setup["batch"], mesh))
    return {k: float(v) for k, v in scalars.items()}


def _jax_eval(setup, rng):
    """The JAX spatial eval step at dp1 x sp2: its frames and PSNR."""
    mesh = jmesh.make_mesh(jax.devices()[:2], model_parallel=2)
    gen, metrics = j_make_eval_step(setup["model"], mesh=mesh)(setup["ts"].params,
                                                              jmesh.shard_batch(setup["batch"], mesh), rng)
    return {"gen_images": np.asarray(gen), "psnr": float(metrics["psnr"])}


def _one_process(model, batch, noise):
    """One port step without a group: scalars, gradients, parameters after."""
    m = copy.deepcopy(model)
    ts = TrainState(m, *make_optimizers(m), 0, torch.Generator())
    scalars = make_train_step(m)(ts, batch, noise)
    return {"scalars": {k: float(v) for k, v in scalars.items()},
            "grads": {k: p.grad.clone() for k, p in m.named_parameters()}, "state": copy.deepcopy(m.state_dict())}


# one rank of the step runs (argv: the job directory, the rank): each job
# entry one train step under the (data, spatial) mesh of the world; under
# dp1 x sp2 also MultiStep(3) against three single steps, and the eval step
STEP_WORKER = textwrap.dedent(
    """
    import copy, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from video_prediction_torch.parallel.distributed import maybe_initialize
    from video_prediction_torch.parallel.mesh import make_spatial_mesh, shard_batch
    from video_prediction_torch.train.state import TrainState, make_optimizers
    from video_prediction_torch.train.step import make_eval_step, make_train_step

    path, rank = sys.argv[1], int(sys.argv[2])
    job = torch.load(f"{path}/job.pt", weights_only=False)
    assert maybe_initialize(f"file://{path}/rendezvous", job["world"], rank, device="cpu")
    try:
        world = dist.group.WORLD
        sp = make_spatial_mesh(2)

        def mine(batch, stacked=False):
            return shard_batch(batch, sp.data_rank, sp.data_size, stacked, spatial=(sp.coord, sp.k))

        out = {}
        for name, (model, batch, noise) in job["steps"].items():
            m = copy.deepcopy(model)
            ts = TrainState(m, *make_optimizers(m), 0, torch.Generator())
            s = make_train_step(m, group=world, spatial=sp)(ts, mine(batch), noise)
            out[name] = {"scalars": {k: float(v) for k, v in s.items()},
                         "grads": {k: p.grad.clone() for k, p in m.named_parameters()},
                         "state": copy.deepcopy(m.state_dict())}
        if "multi" in job:
            model, batches, noises = job["multi"]
            k = len(batches)
            runs = []
            for multi in (False, True):
                m = copy.deepcopy(model)
                ts = TrainState(m, *make_optimizers(m, k), 0, torch.Generator())
                if multi:
                    step = make_train_step(m, k, group=world, spatial=sp)
                    stack = {key: torch.stack([b[key] for b in batches]) for key in batches[0]}
                    step(ts, mine(stack, stacked=True), noises)
                    rows = step.scalars_by_step
                else:
                    step = make_train_step(m, group=world, spatial=sp)
                    rows = torch.stack([torch.stack([v.float() for v in step(ts, mine(b), n).values()])
                                        for b, n in zip(batches, noises)])
                runs.append({"scalars": rows.clone(), "state": copy.deepcopy(m.state_dict())})
            out["multi"] = runs
            model, batch, zs = job["eval"]
            gen, metrics = make_eval_step(model, world, sp)(mine(batch), zs_prior=zs)
            out["eval"] = {"gen_images": gen.clone(), "metrics": {k: v.clone() for k, v in metrics.items()}}
        torch.save(out, f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    """
)


def _model(th, batch, state_dict=None, seed=0, name="savp"):
    model = t_get_model_class(name)(th, **input_dims(th, batch))
    if state_dict is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return model


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory, vgg_path):
    """The JAX spatial steps (the flagship at dp1 x sp2 and dp2 x sp2, the
    bf16 config at dp1 x sp2, the flagship's spatial eval step); the port's
    one-process steps from the same weights and noise (the bf16 config also
    at fp32, its yardstick), and from seeded weights for every option; the
    same steps at 2 ranks (and the flagship at 4) from the spawned ranks'
    files, with MultiStep(3) and the eval step. The ranks run while this
    process runs the JAX jits and the one-process steps."""
    host = [{k: v for k, v in h.items() if k != "states"} for h in _host_batch()]  # the flagship has no states
    batch = {k: torch.from_numpy(v) for k, v in host[0].items()}
    setups = {name: _jax_setup(zoo, host[0]) for name, zoo in (("flagship", FLAGSHIP), ("bf16", BF16))}
    steps = {}
    for name, zoo in (("flagship", FLAGSHIP), ("bf16", BF16)):
        th = _port_hparams(zoo)
        steps[name] = (_model(th, batch, setups[name]["state_dict"]), batch,
                       _jax_noise(setups[name]["ts"].rng, 0, B, T, th))
    with_states = {k: torch.from_numpy(v) for k, v in _host_batch()[0].items()}
    for name, (model_name, zoo, extra) in OPTIONS.items():
        if "vgg_cdist_weight" in extra:
            extra = dict(extra, vgg_weights_path=vgg_path)
        model = _model(_port_hparams(zoo, model_name, **extra), with_states, seed=1, name=model_name)
        steps[name] = (model, with_states, model.draw_noise(B, T, torch.Generator().manual_seed(2)))
    model = steps["flagship"][0]
    batches = [{k: torch.from_numpy(v) for k, v in h.items()} for h in host]
    noises = [model.draw_noise(B, T, torch.Generator().manual_seed(10 + i)) for i in range(MULTI_K)]
    eval_rng = jax.random.PRNGKey(3)
    zs = torch.from_numpy(np.array(jax.random.normal(jax.random.split(eval_rng, 3)[2], (B, T - 1, SMALL["nz"]))))
    paths = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        spawned = []
        for world, job in ((2, {"steps": steps, "multi": (model, batches, noises), "eval": (model, batch, zs)}),
                           (4, {"steps": {"flagship": steps["flagship"]}})):
            paths[world] = tmp_path_factory.mktemp(f"steps{world}")
            torch.save({"world": world, **job}, paths[world] / "job.pt")
            spawned.append(pool.submit(spawn, STEP_WORKER, paths[world], world=world))
        jax_runs = {"dp1xsp2": _jax_step(setups["flagship"], 2), "dp2xsp2": _jax_step(setups["flagship"], 4),
                    "bf16": _jax_step(setups["bf16"], 2), "eval": _jax_eval(setups["flagship"], eval_rng)}
        one = {name: _one_process(*step) for name, step in steps.items()}
        th32 = _port_hparams(BF16, compute_dtype="float32")
        one["bf16_fp32"] = _one_process(_model(th32, batch, setups["bf16"]["state_dict"]), batch, steps["bf16"][2])
        for future in spawned:
            future.result()
    ranks = {world: [torch.load(path / f"rank{r}.pt", weights_only=False) for r in range(world)]
             for world, path in paths.items()}
    return {"jax": jax_runs, "one": one, "ranks": ranks, "lr": {n: s[0].hparams.lr for n, s in steps.items()}}


def _assert_grads_close(grads, want, label):
    gmax = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        tol = GRAD_TOL * float(g.abs().max()) + GRAD_FLOOR * gmax
        err = float((grads[name] - g).abs().max())
        assert err <= tol, f"{label}: gradient of {name}: max |dg| {err:.3g}, tolerance {tol:.3g}"
    return gmax


def _assert_params_close(state, want, grads, lr, label):
    """Within PARAM_ATOL where Adam's first step is settled (|g| ten times the
    gradient tolerance and above 1e-6), within 2 lr elsewhere."""
    gmax = max(float(g.abs().max()) for g in grads.values())
    settled_leaves = 0
    for name, g in grads.items():
        diff = (state[name] - want[name]).abs()
        assert float(diff.max()) <= 2.0 * lr + 1e-6, f"{label}: {name}"
        settled = g.abs() > max(10.0 * (GRAD_TOL * float(g.abs().max()) + GRAD_FLOOR * gmax), 1e-6)
        if settled.any():
            settled_leaves += 1
            assert float(diff[settled].max()) <= PARAM_ATOL, f"{label}: {name}: {float(diff[settled].max()):.3g}"
    assert settled_leaves > len(grads) // 2


@pytest.mark.parametrize("world", [2, 4], ids=["dp1xsp2", "dp2xsp2"])
def test_spatial_step_losses_match_jax(step_runs, world):
    """Every loss term of the flagship's step within rel 1e-5 of the JAX
    package's spatial step on the same mesh shape, JAX's own bar for its
    spatial step against one device (``tests/test_model_train.py:294-295``)."""
    want = step_runs["jax"][f"dp{world // 2}xsp2"]
    for r, out in enumerate(step_runs["ranks"][world]):
        got = out["flagship"]["scalars"]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=1e-7, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", [2, 4], ids=["dp1xsp2", "dp2xsp2"])
def test_spatial_step_equals_the_one_process_step(step_runs, world):
    """The flagship at 2 and 4 ranks against the port's one-process step on
    the whole batch: every loss term within 1e-5, every gradient leaf
    within ``tests/test_torch_parallel.py``'s tolerance, the parameters
    after Adam's first step within 5e-5 where it is settled."""
    one = step_runs["one"]["flagship"]
    for r, out in enumerate(step_runs["ranks"][world]):
        got = out["flagship"]
        for k, v in one["scalars"].items():
            np.testing.assert_allclose(got["scalars"][k], v, rtol=LOSS_RTOL, atol=1e-7, err_msg=f"rank {r}: {k}")
        _assert_grads_close(got["grads"], one["grads"], f"rank {r}")
        _assert_params_close(got["state"], one["state"], one["grads"], step_runs["lr"]["flagship"], f"rank {r}")


@pytest.mark.parametrize("world", [2, 4], ids=["dp1xsp2", "dp2xsp2"])
def test_spatial_ranks_hold_equal_parameters_u_and_scalars(step_runs, world):
    ranks = step_runs["ranks"][world]
    assert any(k.endswith(".u") for k in ranks[0]["flagship"]["state"])
    for name in ranks[0]:
        if name in ("multi", "eval"):
            continue
        a = ranks[0][name]
        for r, out in enumerate(ranks[1:], 1):
            for k, v in a["state"].items():
                assert torch.equal(v, out[name]["state"][k]), f"{name}: rank {r}: {k}"
            assert out[name]["scalars"] == a["scalars"], f"{name}: rank {r} reports other scalars"


def test_spatial_bf16_step(step_runs):
    """``synthetic/ours_savp`` (bf16 compute, merged gate convs) at dp1 x sp2:
    each loss term within rel 1e-5 of the JAX spatial bf16 step's, or under
    the bf16 rule; against the port's one-process bf16 step each loss term
    and gradient leaf under the bf16 rule, the same config at fp32 the
    yardstick (the shards round their convs' bf16 sums apart)."""
    want = step_runs["jax"]["bf16"]
    one, one32 = step_runs["one"]["bf16"], step_runs["one"]["bf16_fp32"]
    for r, out in enumerate(step_runs["ranks"][2]):
        got = out["bf16"]
        assert sorted(got["scalars"]) == sorted(want)
        for k, v in want.items():
            lhs, rhs = abs(got["scalars"][k] - v), abs(one["scalars"][k] - one32["scalars"][k])
            assert lhs <= max(LOSS_RTOL * abs(v) + 1e-7, BF16_RATIO * rhs), f"rank {r}: {k}: {lhs:.3g} vs {rhs:.3g}"
        for name, g in one["grads"].items():
            lhs = float((got["grads"][name] - g).abs().max())
            rhs = float((g - one32["grads"][name]).abs().max())
            bound = BF16_GRAD_RATIO * rhs + BF16_ULP * float(one32["grads"][name].abs().max())
            assert lhs <= bound, f"rank {r}: gradient of {name}: {lhs:.3g} > {bound:.3g}"


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_spatial_step_with_each_generator_option(step_runs, option):
    """Each generator option and zoo file at dp1 x sp2 against the port's
    one-process step on the same weights, batch and noise: loss terms,
    gradients, parameters."""
    one = step_runs["one"][option]
    for r, out in enumerate(step_runs["ranks"][2]):
        got = out[option]
        assert sorted(got["scalars"]) == sorted(one["scalars"])
        for k, v in one["scalars"].items():
            np.testing.assert_allclose(got["scalars"][k], v, rtol=LOSS_RTOL, atol=1e-7, err_msg=f"rank {r}: {k}")
        _assert_grads_close(got["grads"], one["grads"], f"rank {r}")
        _assert_params_close(got["state"], one["state"], one["grads"], step_runs["lr"][option], f"rank {r}")


def test_spatial_multistep_equals_single_steps(step_runs):
    """``MultiStep(3)`` at dp1 x sp2 (eager on the CPU) against three single
    spatial steps with the same Adams: every step's scalars within 1e-5, the
    parameters within Adam's bound."""
    lr = step_runs["lr"]["flagship"]
    for r, out in enumerate(step_runs["ranks"][2]):
        single, multi = out["multi"]
        np.testing.assert_allclose(multi["scalars"].numpy(), single["scalars"].numpy(), rtol=LOSS_RTOL, atol=1e-7)
        for name, v in single["state"].items():
            assert float((multi["state"][name] - v).abs().max()) <= 2.0 * lr * MULTI_K + 1e-6, f"rank {r}: {name}"


def test_spatial_eval_matches_jax(step_runs):
    """The eval step at dp1 x sp2: each rank's rows of ``gen_images`` put
    together within atol 1e-5 of the JAX spatial eval step's frames, and
    PSNR within rel 1e-5 on every rank (``tests/test_model_train.py:303-315``)."""
    want = step_runs["jax"]["eval"]
    ranks = step_runs["ranks"][2]
    gen = torch.cat([out["eval"]["gen_images"] for out in ranks], dim=2)
    np.testing.assert_allclose(gen.numpy(), want["gen_images"], atol=1e-5)
    for out in ranks:
        np.testing.assert_allclose(float(out["eval"]["metrics"]["psnr"]), want["psnr"], rtol=1e-5)
        for k, v in ranks[0]["eval"]["metrics"].items():
            assert torch.equal(out["eval"]["metrics"][k], v), k


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_SMALL = "ngf=4,nef=8,ndf=4,nz=4,sequence_length=5,clip_length=4,schedule_sampling_k=2.0"
ZOO = thp.zoo_dir() / FLAGSHIP / "model_hparams.json"

# one rank of the CLI (argv: the job directory, the rank): each argv of the
# job in turn, its printed lines and summary kept
CLI_WORKER = textwrap.dedent(
    """
    import contextlib, io, json, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from video_prediction_torch.parallel.distributed import maybe_initialize
    from video_prediction_torch.train.__main__ import main

    path, rank = sys.argv[1], int(sys.argv[2])
    with open(f"{path}/argv.json") as f:
        runs = json.load(f)
    assert maybe_initialize(f"file://{path}/rendezvous", 2, rank, device="cpu")
    out = []
    try:
        for argv in runs:
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                summary = main(argv)
            out.append({"summary": summary, "log": log.getvalue()})
    finally:
        dist.destroy_process_group()
    torch.save(out, f"{path}/rank{rank}.pt")
    """
)


def _cli_argv(run_dir, steps, *extra):
    return ["--dataset", "synthetic", "--model", "savp", "--model_hparams_dict", str(ZOO), "--model_hparams",
            CLI_SMALL, "--output_dir", str(run_dir), "--max_steps", str(steps), "--batch_size", "2", "--device",
            "cpu", "--seed", "3", "--spatial_shards", "2", "--progress_freq", "1", "--summary_freq", "1",
            "--image_summary_freq", "2", "--eval_summary_freq", "2", "--save_freq", "2", *extra]


def test_cli_trains_resumes_and_writes_from_rank_0_at_two_shards(tmp_path):
    """Two gloo ranks, ``--spatial_shards 2`` (dp1 x sp2) on 64 px: 2 steps
    with the summaries, a gathered GIF and an eval firing, then ``--resume``
    to 3; both ranks log the axes and end with the same scalars; rank 0's
    checkpoint and event files."""
    from video_prediction_torch.train.checkpoint import PARAMS_FILE, TRAIN_STATE_FILE, checkpoint_file
    from video_prediction_torch.utils.summary import read_events

    run = tmp_path / "run"
    (tmp_path / "argv.json").write_text(json.dumps([_cli_argv(run, 2), _cli_argv(run, 3, "--resume")]))
    spawn(CLI_WORKER, tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    first, resumed = ranks[0]
    assert "data axis: 1, spatial axis: 2" in first["log"]
    assert (first["summary"]["step"], resumed["summary"]["start_step"], resumed["summary"]["step"]) == (2, 2, 3)
    assert "resumed from step 2" in resumed["log"] and "eval/psnr" in first["summary"]["summaries"]
    assert first["summary"]["all_finite"] and resumed["summary"]["all_finite"]
    assert ranks[1][0]["log"] == "" and ranks[1][1]["summary"]["scalars"] == resumed["summary"]["scalars"]
    assert torch.load(checkpoint_file(run, TRAIN_STATE_FILE), weights_only=True)["step"] == 3
    assert os.path.isfile(checkpoint_file(run, PARAMS_FILE))
    tags = {}
    for path in sorted(run.glob("events.out.tfevents.*")):
        for event in read_events(str(path)):
            for tag, _ in event.values:
                tags.setdefault(tag, []).append(event.step)
    assert tags["g_loss"] == [1, 2, 3] and tags["gen_images"] == [2], tags


def test_cli_refuses_two_shards_in_one_process(tmp_path):
    from video_prediction_torch.train.__main__ import main

    with pytest.raises(ValueError, match="1 ranks not divisible by spatial_shards=2"):
        main(_cli_argv(tmp_path / "run", 1))

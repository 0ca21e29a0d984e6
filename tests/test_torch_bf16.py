"""Mixed precision (``compute_dtype`` / ``gate_dtype``) against the JAX
package, on the CPU.

The rule, one for every comparison here: from the same converted weights and
inputs, ``max|port_bf16 - jax_bf16| <= 2 * max|jax_bf16 - jax_fp32|``, and the
right-hand side is nonzero (the bf16 run must differ from the fp32 one, or
the rule says nothing). Where nothing is bf16 (fp32 compute and gates) the
fp32 tolerance of ``test_torch_rnn.py`` holds instead; the spectral ``u``
(fp32 power iteration whatever the dtype) must match to fp32.

Measured on the CPU, max|port - jax_bf16| / max|jax_bf16 - jax_fp32|:
- ``ConvLSTMCell``: bf16 compute with fp32 gates 0 (equal, with or without
  norm); bf16 gates with norm (K2, which rounds no intermediate where the
  JAX cell rounds each to bf16) at most 1.03 in c and 1.18 in h with fp32
  compute, 1.02 and 1.18 with bf16 compute; bf16 gates without norm at most
  1.39 (torch rounds every op, XLA fuses some in fp32);
- ``Conv2D`` (stride 1, 2), ``UpsampleConv2D``, the dense layer and the
  three norms 0 (equal); ``ConvPool2D`` 0.78 (the pool's sum);
- ``PosteriorEncoder`` (16 px) at most 1.12 (per step) and 0.67 (one z);
  the video discriminator's logits 0, its features at most 0.87;
- ``forward(train=False)``: ``gen_images`` 0.71 on
  ``bair_action_free/ours_savp_tpu`` and 1.09 on ``synthetic/ours_savp``
  (five recurrent steps; 2.2 on the latter before the convs added their
  bias after rounding the product, as flax does);
- the ``ours_savp_tpu`` train step: loss terms at most 0.64, gradients leaf
  by leaf at most 3.09 under a ratio of 4 (the test's docstring), and the
  same file at fp32 against the JAX fp32 step leaf by leaf.
Small shapes, as ``test_torch_model.py``: 32 px, ngf=4, nef=8, nz=4, 6
frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as flax_nn

from video_prediction_torch.configs import hparams as thp
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.models import get_model_class as t_get_model_class
from video_prediction_torch.models.networks import PosteriorEncoder as TPosterior
from video_prediction_torch.models.networks import VideoSNDiscriminator as TDisc
from video_prediction_torch.ops import layers as T
from video_prediction_torch.ops.rnn import ConvLSTMCell
from video_prediction_tpu.configs import hparams as jhp
from video_prediction_tpu.data.synthetic import SyntheticVideoDataset
from video_prediction_tpu.models import get_model_class as j_get_model_class
from video_prediction_tpu.models import networks as jnet
from video_prediction_tpu.ops import layers as J
from video_prediction_tpu.ops import rnn as jrnn

torch.set_num_threads(1)

RATIO = 2.0
FP32_ATOL = 1e-5  # nothing in bf16: one fp32 conv step plus the gate maths
# the train step's gradients, leaf by leaf (test_train_step_bf16_matches_jax)
GRAD_RATIO = 4.0  # the worst sound reading is 3.09
GRAD_FLOOR = 2.0**-8  # of the leaf's max|jax fp32|: one bf16 rounding of its largest entry
FP32_GRAD_RTOL = 1e-3  # of the leaf's max, at fp32 dtypes (measured at most 2.8e-4)
FP32_GRAD_ATOL = 1e-6  # of the model's largest gradient: the biases before a norm have none
LOSS_RTOL = 1e-4  # the fp32 loss terms (the GAN fake terms near 6e-6 read 1.2e-5: their logits near -12)
SMALL = dict(ngf=4, nef=8, nz=4, sequence_length=6)
# the KL term at full weight from step 0, so that it enters the comparison
TRAIN_SMALL = dict(SMALL, ndf=4, clip_length=4, kl_anneal="none", schedule_sampling_k=2.0, batch_size=2)
# the zoo files that set compute_dtype bfloat16: (dataset, config)
BF16_ZOO = [("bair", "ours_savp_tpu"), ("bair_action_free", "ours_savp_tpu"), ("kth", "ours_savp_tpu"),
            ("synthetic", "ours_savp"), ("synthetic", "ours_deterministic_l1")]
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(a) -> np.ndarray:
    """fp32 numpy of a JAX array or a torch tensor of any float dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _max_diff(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


def assert_ratio(port_bf16, jax_bf16, jax_fp32, name="") -> float:
    """The rule; returns the measured ratio."""
    lhs, rhs = _max_diff(port_bf16, jax_bf16), _max_diff(jax_bf16, jax_fp32)
    assert rhs > 0.0, f"{name}: the bf16 run equals the fp32 run, the rule would be vacuous"
    assert lhs <= RATIO * rhs, f"{name}: max|port - jax_bf16| {lhs:.3g} > {RATIO} x max|jax_bf16 - jax_fp32| {rhs:.3g}"
    return lhs / rhs


def _perturbed(params, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + scale * rng.randn(*a.shape).astype(np.float32), params)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gate_conv", ["split", "merged"])
@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("gate_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_conv_lstm_cell_dtypes(compute_dtype, gate_dtype, use_norm, gate_conv):
    """The state is kept in the compute dtype (as the generator makes it);
    the input arrives in it."""
    b, h, w, cin, f = 2, 6, 6, 5, 8
    x, c0, h0 = _x((b, h, w, cin), 0), _x((b, h, w, f), 1), _x((b, h, w, f), 2)

    def jax_cell(cdt, gdt):
        cell = jrnn.ConvLSTMCell(f, 5, use_norm=use_norm, gate_conv=gate_conv,
                                 dtype=None if cdt == "float32" else JDTYPE[cdt], gate_dtype=JDTYPE[gdt])
        sdt = JDTYPE[cdt]
        return cell, (jnp.asarray(c0, sdt), jnp.asarray(h0, sdt)), jnp.asarray(x, sdt)

    cell32, carry32, x32 = jax_cell("float32", "float32")
    params = _perturbed(cell32.init(jax.random.PRNGKey(0), carry32, x32)["params"], 3)
    (c_ref32, h_ref32), _ = cell32.apply({"params": params}, carry32, x32)
    cell, carry, xj = jax_cell(compute_dtype, gate_dtype)
    (c_ref, h_ref), _ = cell.apply({"params": params}, carry, xj)

    sdt = TDTYPE[compute_dtype]
    tcell = ConvLSTMCell(cin, f, use_norm=use_norm, gate_conv=gate_conv,
                         dtype=None if compute_dtype == "float32" else sdt, gate_dtype=TDTYPE[gate_dtype])
    tcell.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        (c1, h1), y = tcell((torch.from_numpy(c0).to(sdt), torch.from_numpy(h0).to(sdt)), torch.from_numpy(x).to(sdt))
    assert c1.dtype == h1.dtype == y.dtype == sdt
    assert str(c_ref.dtype) == compute_dtype
    if compute_dtype == gate_dtype == "float32":
        np.testing.assert_allclose(_np(c1), _np(c_ref), atol=FP32_ATOL)
        np.testing.assert_allclose(_np(h1), _np(h_ref), atol=FP32_ATOL)
    else:
        assert_ratio(c1, c_ref, c_ref32, "c")
        assert_ratio(h1, h_ref, h_ref32, "h")


def _layer_pair(kind, dtype):
    jd, td = (None, None) if dtype is None else (jnp.bfloat16, torch.bfloat16)
    if kind == "conv":
        return J.Conv2D(6, 3, 1, dtype=jd), T.Conv2D(5, 6, 3, dtype=td)
    if kind == "conv_stride2":
        return J.Conv2D(6, 4, 2, dtype=jd), T.Conv2D(5, 6, 4, strides=2, dtype=td)
    if kind == "conv_pool":
        return J.ConvPool2D(6, dtype=jd), T.ConvPool2D(5, 6, dtype=td)
    if kind == "upsample_conv":
        return J.UpsampleConv2D(6, dtype=jd), T.UpsampleConv2D(5, 6, dtype=td)
    if kind == "dense":
        return flax_nn.Dense(6, dtype=jd), T.Dense(5, 6, dtype=td)
    return J.get_norm_layer(kind)(dtype=jd), T.get_norm_layer(kind)(8 if kind == "group" else 5, dtype=td)


@pytest.mark.parametrize("kind", ["conv", "conv_stride2", "conv_pool", "upsample_conv", "dense",
                                  "instance", "layer", "group"])
def test_layers_bf16(kind):
    """A layer built with bf16 returns bf16, from a bf16 input; built with no
    dtype it promotes a bf16 input with its fp32 parameters to fp32."""
    shape = (3, 5) if kind == "dense" else (2, 8, 8, 8 if kind == "group" else 5)
    x = _x(shape, 4) * 2.0 + 0.5
    j16, t16 = _layer_pair(kind, "bfloat16")
    j32, t32 = _layer_pair(kind, None)
    params = _perturbed(j32.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 5)
    ref32 = j32.apply({"params": params}, jnp.asarray(x))
    ref16 = j16.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    promoted = j32.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    sd = flax_to_state_dict(params)
    t16.load_state_dict(sd)
    t32.load_state_dict(sd)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        out16, out_promoted = t16(xb), t32(xb)
    assert out16.dtype == torch.bfloat16 and ref16.dtype == jnp.bfloat16
    assert_ratio(out16, ref16, ref32, kind)
    # no dtype: the bf16 input promotes with the fp32 parameters (norms:
    # fp32 statistics of the bf16 values)
    assert out_promoted.dtype == torch.float32 and promoted.dtype == jnp.float32
    np.testing.assert_allclose(_np(out_promoted), _np(promoted), atol=FP32_ATOL, rtol=1e-5)


@pytest.mark.parametrize("time_invariant", [False, True], ids=["per_step", "one_z"])
def test_posterior_encoder_bf16(time_invariant):
    """bf16 convs; the instance norms and the mu/logvar heads have no dtype and
    promote to fp32; fp32 out."""
    images = np.random.RandomState(6).rand(2, 5, 16, 16, 3).astype(np.float32)

    def jax_enc(dt):
        return jnet.PosteriorEncoder(nz=4, nef=8, time_invariant=time_invariant, dtype=dt)

    params = _perturbed(jax_enc(None).init(jax.random.PRNGKey(2), jnp.asarray(images))["params"], 7)
    ref32 = jax.jit(jax_enc(None).apply)({"params": params}, jnp.asarray(images))
    ref16 = jax.jit(jax_enc(jnp.bfloat16).apply)({"params": params}, jnp.asarray(images))
    tenc = TPosterior(3, nz=4, nef=8, time_invariant=time_invariant, dtype=torch.bfloat16)
    tenc.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        out = tenc(torch.from_numpy(images))
    for name, o, r16, r32 in zip(("mu", "logvar"), out, ref16, ref32):
        assert o.dtype == torch.float32 and r16.dtype == jnp.float32
        assert_ratio(o, r16, r32, name)


def test_video_discriminator_bf16():
    """bf16 spectral convs and dense layer: logits and every feature map under
    the rule; the moved u (fp32 power iteration) equal to fp32.

    The logits are two numbers, so the rule is brittle for them: on 16 px
    clips (tried while trimming this test's time) the port's logits are one
    bf16 ulp (4.9e-4) from the JAX bf16 ones, which lie 8.5e-5 from fp32, and
    the rule fails; on these 32 px clips they are equal."""
    clips = np.random.RandomState(9).rand(2, 4, 32, 32, 3).astype(np.float32)

    def jax_disc(dt):
        return jnet.VideoSNDiscriminator(ndf=4, dtype=dt)

    variables = jax_disc(None).init(jax.random.PRNGKey(3), jnp.asarray(clips))
    params = _perturbed(variables["params"], 10, scale=0.05)
    refs = {}
    for key, dt in (("f32", None), ("b16", jnp.bfloat16)):
        (logits, feats), new = jax_disc(dt).apply({"params": params, "spectral": variables["spectral"]},
                                                  jnp.asarray(clips), mutable=["spectral"])
        refs[key] = (logits, feats, new["spectral"])
    tdisc = TDisc(3, (4, 32, 32), ndf=4, dtype=torch.bfloat16)
    tdisc.load_state_dict(flax_to_state_dict(params, variables["spectral"]))
    with torch.no_grad():
        logits, feats, new_u = tdisc(torch.from_numpy(clips))
    assert logits.dtype == torch.bfloat16 and all(f.dtype == torch.bfloat16 for f in feats)
    assert_ratio(logits, refs["b16"][0], refs["f32"][0], "logits")
    for i, (f, f16, f32) in enumerate(zip(feats, refs["b16"][1], refs["f32"][1])):
        assert_ratio(f, f16, f32, f"feature {i}")
    ref_u = flax_to_state_dict({}, refs["b16"][2])
    start_u = flax_to_state_dict({}, variables["spectral"])
    for layer, u in new_u.items():
        assert u.dtype == torch.float32
        if u.numel() > 1:  # sn_fc's u has one entry, +-1 whatever the iteration
            assert float((u - start_u[f"{layer}.u"]).abs().max()) > 0.0, f"{layer}: u did not move"
        np.testing.assert_allclose(u.numpy(), ref_u[f"{layer}.u"].numpy(), atol=1e-5, err_msg=layer)


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------
def _hparams(module, dataset, config, model="savp", **extra):
    get_model_class = j_get_model_class if module is jhp else t_get_model_class
    zoo = module.zoo_dir() / dataset / config / "model_hparams.json"
    return module.resolve_model_hparams(get_model_class(model).default_hparams(), str(zoo), extra=extra)


def _batch(mode="test"):
    raw = next(SyntheticVideoDataset(mode=mode, seed=0, image_size=32).make_iterator(2))
    return {"images": raw["images"][:, :6], "actions": raw["actions"][:, :6]}


def _init_params(jmodel, jbatch):
    params, state = jmodel.init_variables(jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(0)
    # every leaf off its init value, as test_torch_model.py moves them
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) * (1.0 + 0.2 * rng.randn(*a.shape)).astype(np.float32)
        + 0.05 * rng.randn(*a.shape).astype(np.float32),
        params,
    )
    return params, state


@pytest.mark.parametrize("dataset,config", [("bair_action_free", "ours_savp_tpu"), ("synthetic", "ours_savp")])
def test_prior_rollout_bf16_matches_jax(dataset, config):
    """``forward(train=False)``: the JAX model at the zoo file's dtypes and at
    fp32 (the same file with both dtypes float32), the port at the file's."""
    jh = _hparams(jhp, dataset, config, **SMALL)
    assert jh.compute_dtype == "bfloat16"
    jh32 = jh.replace(compute_dtype="float32", gate_dtype="float32")
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, state = _init_params(j_get_model_class("savp")(jh32, mode="test"), jbatch)
    outs = {}
    for key, hp in (("b16", jh), ("f32", jh32)):
        jmodel = j_get_model_class("savp")(hp, mode="test")
        outs[key] = jax.jit(lambda p, b, r: jmodel.forward(p, b, r, jnp.zeros((), jnp.int32), train=False))(
            params, jbatch, jax.random.PRNGKey(1))
    np.testing.assert_array_equal(np.asarray(outs["b16"]["zs_sampled_prior"]), np.asarray(outs["f32"]["zs_sampled_prior"]))

    tmodel = t_get_model_class("savp")(_hparams(thp, dataset, config, **SMALL), image_shape=(32, 32, 3), action_dim=4)
    tmodel.load_state_dict(flax_to_state_dict(params, {"discriminator": state.get("spectral", {})}))
    with torch.no_grad():
        tout = tmodel({k: torch.from_numpy(v) for k, v in batch.items()}, train=False,
                      zs_prior=torch.from_numpy(np.array(outs["b16"]["zs_sampled_prior"])))
    assert tout["gen_images"].dtype == torch.float32 and tout["gen_images"].shape == (2, 5, 32, 32, 3)
    assert bool(torch.isfinite(tout["gen_images"]).all())
    for k in ("gen_images", "zs_mu", "zs_logvar"):
        assert_ratio(tout[k], outs["b16"][k], outs["f32"][k], k)


@pytest.mark.parametrize("dataset,config", BF16_ZOO, ids=["/".join(dc) for dc in BF16_ZOO])
def test_bf16_zoo_files_build_and_roll_out(dataset, config):
    """The port builds every zoo file that sets ``compute_dtype`` bfloat16 (at
    a small width) and rolls it out: fp32 images in, finite fp32 frames out."""
    cls = t_get_model_class("savp")
    hp = _hparams(thp, dataset, config, **SMALL)
    assert hp.compute_dtype == "bfloat16"
    model = cls(hp, image_shape=(32, 32, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model({k: torch.from_numpy(v[:1]) for k, v in _batch().items()},
                    generator=torch.Generator().manual_seed(1))
    assert out["gen_images"].dtype == torch.float32 and bool(torch.isfinite(out["gen_images"]).all())
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
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


def bf16_leaf_failures(port16, jax16, jax32) -> dict:
    """The leaves (name -> (lhs, rhs)) that break the bf16 gradient rule,
    ``max|port - jax_bf16| <= GRAD_RATIO * max|jax_bf16 - jax_fp32| +
    GRAD_FLOOR * max|jax_fp32|``, each leaf on its own."""
    out = {}
    for n, g in port16.items():
        lhs, rhs = _max_diff(g, jax16[n]), _max_diff(jax16[n], jax32[n])
        if not lhs <= GRAD_RATIO * rhs + GRAD_FLOOR * float(np.abs(_np(jax32[n])).max()):
            out[n] = (lhs, rhs)
    return out


def fp32_leaf_failures(port32, jax32, atol: float) -> dict:
    """The leaves (name -> max|port - jax|) off the JAX fp32 gradient by more
    than ``FP32_GRAD_RTOL`` of the leaf's max plus ``atol``."""
    out = {}
    for n, g in port32.items():
        err = _max_diff(g, jax32[n])
        if not err <= FP32_GRAD_RTOL * float(np.abs(_np(jax32[n])).max()) + atol:
            out[n] = err
    return out


def test_train_step_bf16_matches_jax():
    """``compute_losses`` and its gradients on ``ours_savp_tpu`` (bf16 compute
    and gates, the split mask head), against the JAX package's step at the
    file's dtypes and at fp32, from the same weights and noise.

    bf16: every loss term under the rule (at most 0.64); the gradients leaf
    by leaf under ``GRAD_RATIO`` 4, plus one bf16 rounding of the leaf's
    largest fp32 entry. 4 and not 2, because the port's autograd rounds every
    bf16 op's gradient to bf16 where XLA keeps some fused backward chains in
    fp32: seven leaves read above 2 (``posterior.logvar.bias`` 3.09,
    ``generator.cell.stem_norm.scale`` 2.94, ``posterior.logvar.weight``
    2.69, ``generator.cell.dec_rnn1.ln`` 2.50, ``stem_norm.bias`` 2.38,
    ``scratch_head.weight`` 2.10, ``up1_norm.scale`` 2.09), the same seven
    with fp32 gates; the other 73 read at most 1.91.

    The bf16 rule alone is weak where the JAX package's own bf16 gradient
    is noise: its ``mask_head.bias`` gradient lies 5.5 from the fp32 one of
    7.5, and on 25 of the 80 leaves a zeroed gradient would pass it. So the
    same file with both dtypes float32 (the same split mask head, which
    ``scan_unroll == 0`` chooses whatever the dtype) is held to the JAX fp32
    step leaf by leaf within ``FP32_GRAD_RTOL`` of the leaf's max (measured
    at most 2.8e-4) plus 1e-6 of the model's largest gradient: a zeroed or
    sign-flipped gradient fails that on every leaf but the seven biases that
    an instance norm follows, whose gradient is zero up to rounding (at most
    2.1e-7 here). The planted faults at the end check both rules."""
    from video_prediction_tpu.train import create_train_state as j_create_train_state

    jh = _hparams(jhp, "bair_action_free", "ours_savp_tpu", **TRAIN_SMALL)
    jh32 = jh.replace(compute_dtype="float32", gate_dtype="float32")
    batch = {k: v for k, v in _batch("train").items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ts = j_create_train_state(j_get_model_class("savp")(jh32, mode="train"), jax.random.PRNGKey(0), jbatch)
    params, _ = _init_params(j_get_model_class("savp")(jh32, mode="train"), jbatch)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    ref = {}
    for key, hp in (("b16", jh), ("f32", jh32)):
        jmodel = j_get_model_class("savp")(hp, mode="train")

        def loss_fn(p):
            return jmodel.compute_losses(p, ts.model_state, jbatch, jax.random.fold_in(ts.rng, 0),
                                         jnp.zeros((), jnp.int32), train=True)

        grads, aux = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
        ref[key] = ({**aux["g_losses"], **aux["d_losses"]}, flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)))

    th = _hparams(thp, "bair_action_free", "ours_savp_tpu", **TRAIN_SMALL)
    spectral = jax.tree_util.tree_map(np.asarray, ts.model_state["spectral"])
    state_dict = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params), {"discriminator": spectral})
    port = {}
    for key, hp in (("b16", th), ("f32", th.replace(compute_dtype="float32", gate_dtype="float32"))):
        model = t_get_model_class("savp")(hp, image_shape=(32, 32, 3), action_dim=4)
        assert model.generator.cell.split_mask_input
        model.load_state_dict(state_dict)
        total, aux = model.compute_losses({k: torch.from_numpy(v) for k, v in batch.items()}, 0,
                                          noise=_noise(ts.rng, 2, 6, hp))
        total.backward()
        named = dict(model.named_parameters())
        assert sorted(named) == sorted(ref[key][1]) and all(p.grad.dtype == torch.float32 for p in named.values())
        port[key] = ({**aux["g_losses"], **aux["d_losses"]}, {n: p.grad for n, p in named.items()})
    assert sorted(port["b16"][0]) == sorted(ref["b16"][0])
    for k, v in port["b16"][0].items():
        assert v.dtype == torch.float32
        assert_ratio(v, ref["b16"][0][k], ref["f32"][0][k], f"loss {k}")
        np.testing.assert_allclose(_np(port["f32"][0][k]), _np(ref["f32"][0][k]), rtol=LOSS_RTOL, err_msg=k)
    grads16, grads32 = port["b16"][1], port["f32"][1]
    ref16, ref32 = ref["b16"][1], ref["f32"][1]
    atol = FP32_GRAD_ATOL * max(float(np.abs(_np(g)).max()) for g in ref32.values())
    assert fp32_leaf_failures(grads32, ref32, atol) == {}
    assert bf16_leaf_failures(grads16, ref16, ref32) == {}

    # planted faults: each rule must fail on them
    for fault in (torch.zeros_like, torch.neg):
        for n in ("generator.cell.mask_head.weight",  # the split mask head's two bf16 convs
                  "generator.cell.dec_rnn0.ln",  # K2 on bf16 z and c
                  "discriminator.video.sn_conv3d0.weight",  # the bf16 discriminator
                  "posterior.logvar.weight"):  # the bf16 posterior's fp32 head
            assert n in bf16_leaf_failures({n: fault(grads16[n])}, ref16, ref32), (fault, n)
        escaped = {n for n, g in grads32.items() if not fp32_leaf_failures({n: fault(g)}, ref32, atol)}
        assert escaped == {n for n, g in ref32.items() if float(np.abs(_np(g)).max()) <= 2 * atol}, (fault, escaped)
        assert len(escaped) <= 7, escaped


# ---------------------------------------------------------------------------
# what each kernel sees
# ---------------------------------------------------------------------------
def test_kernel_dtypes_in_the_bf16_model(monkeypatch):
    """One bf16 rollout and one bf16 train step (``ours_savp_tpu``, CPU: the
    wrappers run the plain versions, which record their inputs' dtypes): K1
    sees fp32 images and kernels, K2 bf16 z and c (fp32 ln_params), K3 fp32
    candidates and logits."""
    import importlib

    # by path: the package exports a function named ``composite``
    cdna, composite, ln_gate = (importlib.import_module(f"video_prediction_torch.kernels.{m}")
                                for m in ("cdna", "composite", "ln_gate"))
    seen = {"K1": set(), "K2": set(), "K3": set()}
    for group, module, name in (("K1", cdna, "apply_cdna_kernels_reference"),
                                ("K2", ln_gate, "fused_ln_gate_reference"),
                                ("K3", composite, "composite_reference")):
        plain = getattr(module, name)

        def record(*args, _plain=plain, _group=group, **kw):
            seen[_group].add(tuple(a.dtype for a in args if isinstance(a, torch.Tensor)))
            return _plain(*args, **kw)

        monkeypatch.setattr(module, name, record)
    th = _hparams(thp, "bair_action_free", "ours_savp_tpu", **TRAIN_SMALL)
    model = t_get_model_class("savp")(th, image_shape=(32, 32, 3), action_dim=4)
    model.init_weights(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch("train").items()}
    with torch.no_grad():
        model(batch, generator=torch.Generator().manual_seed(1))
    total, _ = model.compute_losses(batch, 0, generator=torch.Generator().manual_seed(2))
    total.backward()
    f32, b16 = torch.float32, torch.bfloat16
    assert seen == {"K1": {(f32, f32)}, "K2": {(b16, b16, f32)}, "K3": {(f32, f32)}}, seen


def test_launch_tally_by_dtype():
    """Each counted launch lands in its wrapper's ``launches`` under the
    dtype of its tensors; ``launch_counts`` sums them; a reset clears them."""
    from video_prediction_torch import kernels as K
    from video_prediction_torch.kernels import _lib

    K.reset_launch_counts()
    for dtype in (torch.bfloat16, torch.bfloat16, torch.float32):
        _lib.count_launch(K.fused_ln_gate, dtype)
    _lib.count_launch(K.composite_backward, torch.float32)
    assert K.launch_counts()["fused_ln_gate"] == 3 and K.launch_counts()["composite_backward"] == 1
    assert K.launch_dtypes() == {"fused_ln_gate": {"bfloat16": 2, "float32": 1}, "composite_backward": {"float32": 1}}
    K.reset_launch_counts()
    assert K.launch_dtypes() == {} and set(K.launch_counts().values()) == {0}

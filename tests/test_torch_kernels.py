"""The port's kernels K1-K3 (``video_prediction_torch/kernels``) against the
JAX package: each plain version against the XLA path and against the Pallas
kernel in interpret mode (as ``tests/test_pallas.py`` runs it), and each
backward wrapper's CPU path (autograd of the plain version) against
``jax.vjp`` of the XLA form JAX training differentiates (the Pallas kernels
are forward only), on the same numpy-seeded inputs. On CPU tensors the
wrappers run their plain versions; the CUDA kernels themselves are compared
with the plain versions on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch import kernels as K
from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.ops import cdna as t_cdna
from video_prediction_torch.ops.rnn import ConvLSTMCell
from video_prediction_tpu.ops import cdna as j_cdna
from video_prediction_tpu.ops import pallas_kernels as pk
from video_prediction_tpu.ops import rnn as jrnn

torch.set_num_threads(1)

ATOL = 1e-5  # fp32 kernels: same maths, summation order may differ


def _cdna_inputs(seed, b=2, h=8, w=8, c=3, k=5, n=4):
    rng = np.random.RandomState(seed)
    image = rng.rand(b, h, w, c).astype(np.float32)
    raw = rng.randn(b, k, k, n).astype(np.float32)
    kernels = np.array(j_cdna.normalize_kernels(jnp.asarray(raw), "softmax"))
    return image, raw, kernels


class TestCDNA:
    @pytest.mark.parametrize("shape", [(2, 8, 8, 3, 5, 4), (1, 7, 5, 2, 3, 2)])
    def test_matches_xla_and_pallas(self, shape):
        b, h, w, c, k, n = shape
        image, _, kernels = _cdna_inputs(0, b, h, w, c, k, n)
        out = K.apply_cdna_kernels(torch.from_numpy(image), torch.from_numpy(kernels)).numpy()
        xla = np.asarray(j_cdna.apply_cdna_kernels(jnp.asarray(image), jnp.asarray(kernels)))
        pallas = np.asarray(pk.apply_cdna_kernels_fused(jnp.asarray(image), jnp.asarray(kernels), interpret=True))
        assert out.shape == (b, n, h, w, c)
        np.testing.assert_allclose(out, xla, atol=ATOL)
        np.testing.assert_allclose(out, pallas, atol=ATOL)

    @pytest.mark.parametrize("method", ["softmax", "relu"])
    def test_normalize_kernels(self, method):
        _, raw, _ = _cdna_inputs(1)
        out = t_cdna.normalize_kernels(torch.from_numpy(raw), method).numpy()
        ref = np.asarray(j_cdna.normalize_kernels(jnp.asarray(raw), method))
        np.testing.assert_allclose(out, ref, atol=1e-6)

    def test_ops_entry_point_is_the_wrapper(self):
        assert t_cdna.apply_cdna_kernels is K.apply_cdna_kernels

    @pytest.mark.parametrize("shape", [(2, 8, 8, 3, 5, 4), (1, 7, 5, 2, 3, 2)])
    def test_backward_matches_jax_vjp(self, shape):
        b, h, w, c, k, n = shape
        image, _, kernels = _cdna_inputs(2, b, h, w, c, k, n)
        g = np.random.RandomState(3).randn(b, n, h, w, c).astype(np.float32)
        d_image, d_kernels = K.apply_cdna_kernels_backward(
            torch.from_numpy(image), torch.from_numpy(kernels), torch.from_numpy(g))
        _, vjp = jax.vjp(j_cdna.apply_cdna_kernels, jnp.asarray(image), jnp.asarray(kernels))
        ref_image, ref_kernels = vjp(jnp.asarray(g))
        np.testing.assert_allclose(d_image.numpy(), np.asarray(ref_image), atol=ATOL)
        np.testing.assert_allclose(d_kernels.numpy(), np.asarray(ref_kernels), atol=ATOL * h * w * c)


class TestLNGate:
    @pytest.mark.parametrize("cdim", [8, 32])
    def test_matches_pallas(self, cdim):
        rng = np.random.RandomState(cdim)
        r = 24
        z = (2.0 * rng.randn(r, 4 * cdim)).astype(np.float32)
        c = rng.randn(r, cdim).astype(np.float32)
        lnp = (rng.rand(10, cdim) + 0.5).astype(np.float32)
        lnp[1::2] -= 0.75  # biases of both signs
        c_new, h_new = K.fused_ln_gate(torch.from_numpy(z), torch.from_numpy(c), torch.from_numpy(lnp))
        jc, jh = pk.fused_ln_gate(jnp.asarray(z), jnp.asarray(c), jnp.asarray(lnp), interpret=True)
        np.testing.assert_allclose(c_new.numpy(), np.asarray(jc), atol=ATOL)
        np.testing.assert_allclose(h_new.numpy(), np.asarray(jh), atol=ATOL)

    def test_forget_bias(self):
        rng = np.random.RandomState(3)
        z, c = rng.randn(4, 32).astype(np.float32), rng.randn(4, 8).astype(np.float32)
        lnp = np.ones((10, 8), np.float32)
        out = K.fused_ln_gate(torch.from_numpy(z), torch.from_numpy(c), torch.from_numpy(lnp), forget_bias=0.25)
        ref = pk.fused_ln_gate(jnp.asarray(z), jnp.asarray(c), jnp.asarray(lnp), forget_bias=0.25, interpret=True)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)

    def test_output_dtype_follows_cell_state(self):
        z = torch.zeros(8, 32, dtype=torch.bfloat16)
        c = torch.zeros(8, 8, dtype=torch.bfloat16)
        c_new, h_new = K.fused_ln_gate(z, c, torch.ones(10, 8))
        assert c_new.dtype == torch.bfloat16 and h_new.dtype == torch.bfloat16


    def test_normed_conv_lstm_cell_gradients_match_jax(self):
        """Through the cell, K2's plain version (and the gate convs) against
        ``jax.grad`` of the flax cell's LayerNorm path: gradients of x, c, h
        and every parameter, the five LayerNorms packed into ``ln``."""
        rng = np.random.RandomState(5)
        b, h, w, cin, f = 2, 6, 6, 5, 8
        x, c0, h0 = (rng.randn(b, h, w, d).astype(np.float32) for d in (cin, f, f))
        wc, wh = (rng.randn(b, h, w, f).astype(np.float32) for _ in range(2))
        cell = jrnn.ConvLSTMCell(f, 5, use_norm=True, gate_conv="split")
        params = cell.init(jax.random.PRNGKey(0), (jnp.asarray(c0), jnp.asarray(h0)), jnp.asarray(x))["params"]
        params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.3 * rng.randn(*a.shape).astype(np.float32),
                                        params)

        def loss(p, x_, c_, h_):
            (c1, h1), _ = cell.apply({"params": p}, (c_, h_), x_)
            return jnp.sum(c1 * wc) + jnp.sum(h1 * wh)

        ref = jax.grad(loss, argnums=(0, 1, 2, 3))(params, jnp.asarray(x), jnp.asarray(c0), jnp.asarray(h0))
        tcell = ConvLSTMCell(cin, f, use_norm=True, gate_conv="split")
        tcell.load_state_dict(flax_to_state_dict(params))
        xt, ct, ht = (torch.from_numpy(a).requires_grad_() for a in (x, c0, h0))
        (c1, h1), _ = tcell((ct, ht), xt)
        ((c1 * torch.from_numpy(wc)).sum() + (h1 * torch.from_numpy(wh)).sum()).backward()
        for name, got, want in (("x", xt.grad, ref[1]), ("c", ct.grad, ref[2]), ("h", ht.grad, ref[3])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=name)
        ref_params = flax_to_state_dict(ref[0])
        for name, p in tcell.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), ref_params[name].numpy(), atol=1e-4, rtol=1e-5, err_msg=name)

    def test_backward_wrapper_is_plain_autograd(self):
        rng = np.random.RandomState(6)
        z, c = rng.randn(12, 32).astype(np.float32), rng.randn(12, 8).astype(np.float32)
        lnp = (rng.rand(10, 8) + 0.5).astype(np.float32)
        dcn, dhn = rng.randn(12, 8).astype(np.float32), rng.randn(12, 8).astype(np.float32)
        got = K.fused_ln_gate_backward(*map(torch.from_numpy, (z, c, lnp, dcn, dhn)), forget_bias=0.5)
        leaves = [torch.from_numpy(a).requires_grad_() for a in (z, c, lnp)]
        c_new, h_new = K.fused_ln_gate(*leaves, forget_bias=0.5)
        ((c_new * torch.from_numpy(dcn)).sum() + (h_new * torch.from_numpy(dhn)).sum()).backward()
        for a, leaf in zip(got, leaves):
            np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), atol=1e-6)


class TestComposite:
    def test_matches_pallas_and_einsum(self):
        rng = np.random.RandomState(0)
        b, k, h, w, c = 2, 7, 8, 8, 3
        cand = rng.rand(b, k, h, w, c).astype(np.float32)
        logits = (3.0 * rng.randn(b, h, w, k)).astype(np.float32)
        out, masks = K.composite(torch.from_numpy(cand), torch.from_numpy(logits), with_masks=True)
        pallas = np.asarray(pk.composite_fused(jnp.asarray(cand), jnp.asarray(logits), interpret=True))
        jmasks = jax.nn.softmax(jnp.asarray(logits), axis=-1)
        # the JAX generator's einsum form (models/savp.py:389-390)
        stacked = jnp.moveaxis(jnp.asarray(cand), 1, -1)  # [B,H,W,C,K]
        einsum = np.asarray(jnp.einsum("bhwck,bhwk->bhwc", stacked, jmasks))
        np.testing.assert_allclose(out.numpy(), pallas, atol=ATOL)
        np.testing.assert_allclose(out.numpy(), einsum, atol=ATOL)
        np.testing.assert_allclose(masks.numpy(), np.asarray(jmasks), atol=1e-6)

    def test_backward_matches_jax_vjp(self):
        rng = np.random.RandomState(4)
        b, k, h, w, c = 2, 7, 8, 8, 3
        cand = rng.rand(b, k, h, w, c).astype(np.float32)
        logits = (3.0 * rng.randn(b, h, w, k)).astype(np.float32)
        g = rng.randn(b, h, w, c).astype(np.float32)

        def xla(cand_, logits_):  # models/savp.py:381-390, the einsum form
            return jnp.einsum("bhwck,bhwk->bhwc", jnp.moveaxis(cand_, 1, -1), jax.nn.softmax(logits_, axis=-1))

        _, vjp = jax.vjp(xla, jnp.asarray(cand), jnp.asarray(logits))
        ref_cand, ref_logits = vjp(jnp.asarray(g))
        d_cand, d_logits = K.composite_backward(torch.from_numpy(cand), torch.from_numpy(logits), torch.from_numpy(g))
        np.testing.assert_allclose(d_cand.numpy(), np.asarray(ref_cand), atol=ATOL)
        np.testing.assert_allclose(d_logits.numpy(), np.asarray(ref_logits), atol=ATOL)

    def test_masks_only_on_request(self):
        out, masks = K.composite(torch.rand(1, 3, 4, 4, 1), torch.zeros(1, 4, 4, 3))
        assert masks is None and out.shape == (1, 4, 4, 1)


class TestDispatch:
    """A wrapper runs its plain version for CPU tensors only; anything else
    reaches the kernel or raises. Counters move only on a kernel launch."""

    def test_cpu_runs_plain_version_and_counts_nothing(self):
        K.reset_launch_counts()
        image, _, kernels = _cdna_inputs(0)
        K.apply_cdna_kernels(torch.from_numpy(image), torch.from_numpy(kernels))
        K.fused_ln_gate(torch.zeros(4, 32), torch.zeros(4, 8), torch.ones(10, 8))
        K.composite(torch.rand(1, 3, 4, 4, 1), torch.zeros(1, 4, 4, 3))
        K.apply_cdna_kernels_backward(torch.from_numpy(image), torch.from_numpy(kernels), torch.zeros(2, 4, 8, 8, 3))
        K.fused_ln_gate_backward(torch.zeros(4, 32), torch.zeros(4, 8), torch.ones(10, 8), torch.ones(4, 8),
                                 torch.ones(4, 8))
        K.composite_backward(torch.rand(1, 3, 4, 4, 1), torch.zeros(1, 4, 4, 3), torch.ones(1, 4, 4, 1))
        assert K.launch_counts() == {name: 0 for name in K.WRAPPERS} and len(K.WRAPPERS) == 6

    @pytest.mark.parametrize("name", ["apply_cdna_kernels", "fused_ln_gate", "composite",
                                      "apply_cdna_kernels_backward", "fused_ln_gate_backward",
                                      "composite_backward"])
    def test_non_cpu_device_without_kernel_raises(self, name):
        args = {
            "apply_cdna_kernels": (torch.zeros(1, 4, 4, 3), torch.zeros(1, 3, 3, 2)),
            "fused_ln_gate": (torch.zeros(4, 32), torch.zeros(4, 8), torch.ones(10, 8)),
            "composite": (torch.zeros(1, 3, 4, 4, 1), torch.zeros(1, 4, 4, 3)),
            "apply_cdna_kernels_backward": (torch.zeros(1, 4, 4, 3), torch.zeros(1, 3, 3, 2),
                                            torch.zeros(1, 2, 4, 4, 3)),
            "fused_ln_gate_backward": (torch.zeros(4, 32), torch.zeros(4, 8), torch.ones(10, 8),
                                       torch.zeros(4, 8), torch.zeros(4, 8)),
            "composite_backward": (torch.zeros(1, 3, 4, 4, 1), torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 1)),
        }[name]
        with pytest.raises(ValueError, match="CPU or CUDA"):
            K.WRAPPERS[name](*(a.to("meta") for a in args))

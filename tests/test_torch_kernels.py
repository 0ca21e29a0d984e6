"""The port's kernels K1-K3 (``video_prediction_torch/kernels``) against the
JAX package: each plain version against the XLA path and against the Pallas
kernel in interpret mode (as ``tests/test_pallas.py`` runs it), on the same
numpy-seeded inputs. On CPU tensors the wrappers run their plain versions;
the CUDA kernels themselves are compared with the plain versions on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch import kernels as K
from video_prediction_torch.ops import cdna as t_cdna
from video_prediction_tpu.ops import cdna as j_cdna
from video_prediction_tpu.ops import pallas_kernels as pk

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
        assert K.launch_counts() == {"apply_cdna_kernels": 0, "fused_ln_gate": 0, "composite": 0}

    @pytest.mark.parametrize("name", ["apply_cdna_kernels", "fused_ln_gate", "composite"])
    def test_non_cpu_device_without_kernel_raises(self, name):
        args = {
            "apply_cdna_kernels": (torch.zeros(1, 4, 4, 3), torch.zeros(1, 3, 3, 2)),
            "fused_ln_gate": (torch.zeros(4, 32), torch.zeros(4, 8), torch.ones(10, 8)),
            "composite": (torch.zeros(1, 3, 4, 4, 1), torch.zeros(1, 4, 4, 3)),
        }[name]
        with pytest.raises(ValueError, match="CPU or CUDA"):
            K.WRAPPERS[name](*(a.to("meta") for a in args))

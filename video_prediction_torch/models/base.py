"""Base video-prediction model: the prior-rollout forward pass.

Port of ``video_prediction_tpu/models/base.py`` (reference
``models/base_model.py``), generation side: ``images_to_float``,
``normalize_batch``, ``VideoPredictionModel.__init__`` without
discriminators or VGG, ``_generator_kwargs`` and ``forward`` for the
deterministic model and the eval prior rollout. Training (the posterior and
doubled-batch rollouts, ``compute_losses``, discriminators) and
``metrics_fn`` are still to be ported (ROADMAP.md).

Conventions as in the JAX package: ``batch`` holds ``images [B,T,H,W,C]``
(uint8, or float in [0,1]) and optionally ``actions [B,T or T-1,na]``;
``gen_images [B,T-1,H,W,C]`` aligns with ``images[:, 1:]``. Where the JAX
package draws noise from a key, the port takes it as an input (``zs_prior``)
or draws it from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from video_prediction_torch.configs.hparams import ModelHparams
from video_prediction_torch.models.networks import PosteriorEncoder
from video_prediction_torch.models.savp import SAVPGenerator
from video_prediction_torch.ops.rnn import ConvLSTMCell
from video_prediction_torch.train import schedules


def images_to_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1] on the device; floats pass through."""
    if images.dtype == torch.uint8:
        return images.float() / 255.0
    return images


def normalize_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if "images" in batch and batch["images"].dtype == torch.uint8:
        batch = dict(batch)
        batch["images"] = images_to_float(batch["images"])
    return batch


# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class VideoPredictionModel(nn.Module):
    """Video prediction model (SAVP family): generator plus, when ``nz > 0``,
    the posterior encoder.

    ``image_shape`` (H, W, C) and ``action_dim`` (0 when the dataset has no
    actions) fix the parameter shapes, as the first batch does in the JAX
    package's ``init_variables``. Actions reach the generator whenever the
    batch has them, even under action-free hparams, as in the JAX package.
    """

    def __init__(self, hparams: ModelHparams, *, image_shape: Sequence[int] = (64, 64, 3), action_dim: int = 0):
        super().__init__()
        self.hparams = hparams
        self.generator = SAVPGenerator(hparams, image_shape, action_dim)
        self.posterior = (
            PosteriorEncoder(image_shape[-1], nz=hparams.nz, nef=hparams.nef) if hparams.nz > 0 else None
        )

    @property
    def has_vae(self) -> bool:
        return self.hparams.nz > 0

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Initialize as flax does: lecun-normal conv and dense kernels, zero
        biases, unit norm scales (ConvLSTM ``ln`` rows: scale 1, bias 0)."""
        for module in self.modules():
            for name, p in module.named_parameters(recurse=False):
                if name == "weight":  # conv OIHW or dense [out, in]
                    fan_in = math.prod(p.shape[1:])
                    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
                elif name == "bias":
                    p.zero_()
                elif name == "scale":
                    p.fill_(1.0)
                elif name == "ln" and isinstance(module, ConvLSTMCell):
                    p.zero_()
                    p[0::2] = 1.0
                else:
                    raise AssertionError(f"no init rule for parameter {name!r} of {type(module).__name__}")

    def _generator_kwargs(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        kw = {}
        if batch.get("actions") is not None:
            kw["actions"] = batch["actions"]
        return kw

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        train: bool = False,
        zs_prior: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        output_aux: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """Generator-side forward, eval branch.

        Returns ``gen_images`` and, when stochastic, ``zs_mu``/``zs_logvar``
        from the posterior and the unit-Gaussian prior draws
        ``zs_sampled_prior`` that drove the rollout. ``zs_prior``
        ``[B,T-1,nz]`` is used as given; otherwise it is drawn from
        ``generator`` (a ``torch.Generator`` on the batch's device).
        """
        if train:
            raise NotImplementedError("the training forward is not ported yet (ROADMAP.md, queue 1)")
        hp = self.hparams
        batch = normalize_batch(batch)
        images = batch["images"]
        b, t = images.shape[:2]
        use_gt = schedules.sample_use_gt_mask(b, t, hp, train, device=images.device)
        gen_kwargs = self._generator_kwargs(batch)

        if not self.has_vae:
            return dict(self.generator(images, use_gt, output_aux=output_aux, **gen_kwargs))

        out: Dict[str, torch.Tensor] = {}
        mu_q, logvar_q = self.posterior(images)
        out["zs_mu"], out["zs_logvar"] = mu_q, logvar_q
        if zs_prior is None:
            zs_prior = torch.randn(mu_q.shape, generator=generator, device=images.device)
        elif tuple(zs_prior.shape) != tuple(mu_q.shape):
            raise ValueError(f"zs_prior must be {tuple(mu_q.shape)}, got {tuple(zs_prior.shape)}")
        out["zs_sampled_prior"] = zs_prior
        out.update(self.generator(images, use_gt, zs=zs_prior, output_aux=output_aux, **gen_kwargs))
        return out

"""Base video-prediction model: rollouts and loss assembly.

Port of ``video_prediction_tpu/models/base.py`` (reference
``models/base_model.py``): ``images_to_float``, ``normalize_batch``,
``VideoPredictionModel`` with the generator, the posterior encoder (per step,
or one z per sequence with ``latent_time_invariant``) and the video SN
discriminators, ``forward`` (eval prior rollout, and the training rollouts:
posterior only, or prior and posterior as one doubled batch), ``_clip``,
``apply_discriminator``, ``compute_losses`` and ``metrics_fn``; and the
parameter-free baselines ``GroundTruthVideoPredictionModel`` and
``RepeatVideoPredictionModel``. The image and action-conditioned
discriminators, ``learn_prior``, ``z_l1_weight`` and ``vgg_cdist_weight``
are still to be ported (ROADMAP.md); ``compute_losses`` raises for their loss
weights, and the generator serves such a run all the same.

Conventions as in the JAX package: ``batch`` holds ``images [B,T,H,W,C]``
(uint8, or float in [0,1]) and optionally ``actions [B,T or T-1,na]`` and
``states [B,T,ns]`` (read under ``use_states``); ``gen_images
[B,T-1,H,W,C]`` aligns with ``images[:, 1:]``, ``gen_states [B,T-1,ns]``
with ``states[:, 1:]``. Where the JAX
package draws noise from a key, the port takes it as an input (``zs_prior``
for the eval rollout; the ``noise`` dict of ``draw_noise`` for training) or
draws it from an explicit ``torch.Generator``.

``compute_dtype`` bfloat16 builds the generator, the posterior's convs and
the discriminators in bf16 (``models/base.py:84-112`` of the JAX package);
the parameters stay fp32, the images and ``gen_images`` too, and the losses
(``losses.py``) and metrics (``metrics.py``) cast to fp32, as the JAX
package computes them. There is no loss scaling, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from video_prediction_torch import losses as L
from video_prediction_torch import metrics as M
from video_prediction_torch.configs.hparams import ModelHparams
from video_prediction_torch.models.networks import PosteriorEncoder, VideoSNDiscriminator
from video_prediction_torch.models.savp import SAVPGenerator
from video_prediction_torch.ops.rnn import ConvLSTMCell
from video_prediction_torch.ops.spectral import SpectralLayer, l2_normalize
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


def input_dims(hp: ModelHparams, batch: Dict[str, Any]) -> Dict[str, Any]:
    """The shapes a batch fixes, as the first batch does in the JAX package's
    ``init_variables``: ``image_shape`` (H, W, C), ``action_dim`` (0 without
    actions) and ``state_dim`` (0 unless ``use_states`` and the batch has
    states). The model constructor's keyword arguments."""
    actions, states = batch.get("actions"), batch.get("states")
    return {
        "image_shape": tuple(batch["images"].shape[2:]),
        "action_dim": 0 if actions is None else actions.shape[-1],
        "state_dim": states.shape[-1] if hp.use_states and states is not None else 0,
    }


_UNPORTED_LOSS_WEIGHTS = ("image_sn_gan_weight", "image_sn_vae_gan_weight", "acvideo_sn_gan_weight",
                          "acvideo_sn_vae_gan_weight", "z_l1_weight", "vgg_cdist_weight")


def check_losses_supported(hp: ModelHparams) -> None:
    """Raise ``NotImplementedError`` for a training objective the port lacks."""
    for name in _UNPORTED_LOSS_WEIGHTS:
        if getattr(hp, name):
            raise NotImplementedError(f"{name}={getattr(hp, name)!r} is not ported yet (ROADMAP.md, queue 1)")


# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class VideoPredictionModel(nn.Module):
    """Video prediction model (SAVP family): generator plus, when ``nz > 0``,
    the posterior encoder, plus the video SN discriminators the GAN weights
    ask for (``discriminator["video"]`` for the prior rollout,
    ``discriminator["video_vae"]`` for the posterior one).

    ``image_shape`` (H, W, C), ``action_dim`` (0 when the dataset has no
    actions) and ``state_dim`` (0 unless ``use_states`` and the dataset has
    states) fix the parameter shapes, as the first batch does in the JAX
    package's ``init_variables`` (``input_dims``); the discriminators' dense
    layers take the clip of ``min(clip_length, sequence_length - 1)``
    frames. Actions reach the generator whenever the batch has them, even
    under action-free hparams, as in the JAX package.
    """

    trainable = True

    def __init__(self, hparams: ModelHparams, *, image_shape: Sequence[int] = (64, 64, 3), action_dim: int = 0,
                 state_dim: int = 0):
        super().__init__()
        hp = self.hparams = hparams
        if hp.latent_time_invariant and hp.learn_prior:
            raise ValueError("latent_time_invariant (one z per sequence, SV2P) is incompatible with learn_prior "
                             "(the in-cell prior is per-step by construction)")
        # the compute dtype; None: that of the inputs (fp32)
        dtype = torch.bfloat16 if hp.compute_dtype == "bfloat16" else None
        self.generator = SAVPGenerator(hparams, image_shape, action_dim, state_dim, dtype=dtype)
        self.posterior = (
            PosteriorEncoder(image_shape[-1], nz=hparams.nz, nef=hparams.nef,
                             time_invariant=hparams.latent_time_invariant, dtype=dtype)
            if hparams.nz > 0 else None
        )
        self.discriminator = nn.ModuleDict()
        clip_shape = (min(hp.clip_length, hp.sequence_length - 1), image_shape[0], image_shape[1])
        if hp.video_sn_gan_weight:
            self.discriminator["video"] = VideoSNDiscriminator(image_shape[-1], clip_shape, hp.ndf, dtype)
        if hp.video_sn_vae_gan_weight:
            self.discriminator["video_vae"] = VideoSNDiscriminator(image_shape[-1], clip_shape, hp.ndf, dtype)

    @classmethod
    def default_hparams(cls) -> ModelHparams:
        """The base-model defaults; the zoo classes override them."""
        return ModelHparams()

    @property
    def has_vae(self) -> bool:
        return self.hparams.nz > 0

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Initialize as flax does: lecun-normal conv and dense kernels (zero
        where the layer asks, ``Dense(zero_init=True)``), zero biases and
        learned initial states, unit norm scales (ConvLSTM ``ln`` rows: scale
        1, bias 0), and each spectral ``u`` a normalized Gaussian draw."""
        for module in self.modules():
            for name, p in module.named_parameters(recurse=False):
                if name == "weight" and getattr(module, "zero_init", False):
                    p.zero_()
                elif name == "weight":  # conv OIHW or dense [out, in]
                    fan_in = math.prod(p.shape[1:])
                    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
                elif name == "bias" or name.startswith("init_state_"):
                    p.zero_()
                elif name == "scale":
                    p.fill_(1.0)
                elif name == "ln" and isinstance(module, ConvLSTMCell):
                    p.zero_()
                    p[0::2] = 1.0
                else:
                    raise AssertionError(f"no init rule for parameter {name!r} of {type(module).__name__}")
            if isinstance(module, SpectralLayer):
                module.u.copy_(l2_normalize(torch.randn(module.u.shape, generator=generator)))

    def _generator_kwargs(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        kw = {}
        if batch.get("actions") is not None:
            kw["actions"] = batch["actions"]
        if self.hparams.use_states and batch.get("states") is not None:
            kw["states"] = batch["states"]
        return kw

    def draw_noise(self, batch: int, seq_len: int, generator: Optional[torch.Generator] = None,
                   device: torch.device | str = "cpu") -> Dict[str, Any]:
        """The noise of one training step, from ``generator`` (on ``device``):
        the teacher-forcing mask's uniforms ``use_gt_u [T-1,B]``, the
        posterior's reparameterization noise ``eps_q`` and the prior draws
        ``z_p`` (each ``[B,T-1,nz]``, or ``[B,1,nz]`` with
        ``latent_time_invariant``, when stochastic) and the start of the
        discriminator clip ``clip_start`` (a 0-d long tensor on ``device``,
        never read on the host, so the step queues without a sync)."""
        hp = self.hparams
        noise: Dict[str, Any] = {"use_gt_u": torch.rand((seq_len - 1, batch), generator=generator, device=device)}
        if self.has_vae:
            shape = (batch, 1 if hp.latent_time_invariant else seq_len - 1, hp.nz)
            noise["eps_q"] = torch.randn(shape, generator=generator, device=device)
            noise["z_p"] = torch.randn(shape, generator=generator, device=device)
        clip_len = min(hp.clip_length, seq_len - 1)
        noise["clip_start"] = torch.randint(0, seq_len - clip_len, (), generator=generator, device=device)
        return noise

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        train: bool = False,
        zs_prior: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        output_aux: bool = False,
        step: int = 0,
        noise: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Generator-side forward.

        Eval (``train=False``): returns ``gen_images`` of the prior rollout
        and, when stochastic, ``zs_mu``/``zs_logvar`` from the posterior and
        the unit-Gaussian prior draws ``zs_sampled_prior`` that drove it.
        ``zs_prior`` ``[B,T-1,nz]`` (``[B,1,nz]`` with
        ``latent_time_invariant``: one z per sequence, broadcast over the
        rollout) is used as given; otherwise it is drawn from ``generator`` (a
        ``torch.Generator`` on the batch's device). The latent statistics stay
        un-broadcast, so the KL sees the sequence-level quantities.

        Train: the teacher-forcing mask is sampled at ``step`` from
        ``noise["use_gt_u"]`` and the posterior z is ``mu + exp(logvar/2) *
        noise["eps_q"]`` (``noise`` as ``draw_noise`` gives it, drawn from
        ``generator`` when None). With a GAN weight on the prior rollout the
        prior (``noise["z_p"]``) and posterior rollouts run as one generator
        call on a doubled batch and come back as ``gen_images`` and
        ``gen_images_enc``; otherwise only the posterior rollout runs and
        ``gen_images`` is it.
        """
        hp = self.hparams
        batch = normalize_batch(batch)
        images = batch["images"]
        b, t = images.shape[:2]
        gen_kwargs = self._generator_kwargs(batch)
        if train:
            if noise is None:
                noise = self.draw_noise(b, t, generator, images.device)
            use_gt = schedules.sample_use_gt_mask(b, t, hp, True, images.device, step, noise["use_gt_u"])
        else:
            use_gt = schedules.sample_use_gt_mask(b, t, hp, False, device=images.device)

        if not self.has_vae:
            return dict(self.generator(images, use_gt, output_aux=output_aux, **gen_kwargs))

        out: Dict[str, torch.Tensor] = {}
        mu_q, logvar_q = self.posterior(images)
        out["zs_mu"], out["zs_logvar"] = mu_q, logvar_q

        def bz(z: torch.Tensor) -> torch.Tensor:  # a sequence-level z over every rollout step
            return z.expand(z.shape[0], t - 1, hp.nz)

        if not train:
            if zs_prior is None:
                zs_prior = torch.randn(mu_q.shape, generator=generator, device=images.device)
            elif tuple(zs_prior.shape) != tuple(mu_q.shape):
                raise ValueError(f"zs_prior must be {tuple(mu_q.shape)}, got {tuple(zs_prior.shape)}")
            out["zs_sampled_prior"] = zs_prior
            out.update(self.generator(images, use_gt, zs=bz(zs_prior), output_aux=output_aux, **gen_kwargs))
            return out

        z_q = mu_q + torch.exp(0.5 * logvar_q) * noise["eps_q"]
        z_p = noise["z_p"]
        out["zs_sampled_prior"] = z_p
        if "video" in self.discriminator:
            # the prior and posterior rollouts as one doubled batch
            gout = self.generator(
                torch.cat([images, images]), torch.cat([use_gt, use_gt], dim=1), zs=torch.cat([bz(z_p), bz(z_q)]),
                output_aux=output_aux, **{k: torch.cat([v, v]) for k, v in gen_kwargs.items()},
            )
            for k, v in gout.items():
                out[k], out[k + "_enc"] = v[:b], v[b:]
        else:
            gout = self.generator(images, use_gt, zs=bz(z_q), output_aux=output_aux, **gen_kwargs)
            out.update({k + "_enc": v for k, v in gout.items()})
            out["gen_images"] = gout["gen_images"]  # the posterior rollout doubles as the main output
        return out

    # ------------------------------------------------------------------ #
    # discriminators
    # ------------------------------------------------------------------ #
    def _clip(self, frames: torch.Tensor, start: int | torch.Tensor) -> torch.Tensor:
        """The ``clip_length`` frames from ``start`` (clamped into range),
        selected on the device: a device tensor ``start`` is never read on
        the host."""
        tm1 = frames.shape[1]
        clip_len = min(self.hparams.clip_length, tm1)
        start = torch.as_tensor(start, device=frames.device).clamp(0, tm1 - clip_len)
        return frames.index_select(1, start + torch.arange(clip_len, device=frames.device))

    def apply_discriminator(self, key: str, clips: torch.Tensor, update_spectral: bool
                            ) -> Tuple[torch.Tensor, List[torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
        """Run ``discriminator[key]`` on ``clips``: ``(logits, features,
        new_u)``. With ``update_spectral`` the discriminator's own
        parameters take gradients and the advanced ``u`` vectors come back;
        without, it runs on detached parameters (its gradients flow only
        into ``clips``) from the same stored ``u``, and ``new_u`` is None."""
        disc = self.discriminator[key]
        if update_spectral:
            return disc(clips)
        params = {name: p.detach() for name, p in disc.named_parameters()}
        logits, feats, _ = torch.func.functional_call(disc, params, (clips,))
        return logits, feats, None

    # ------------------------------------------------------------------ #
    # losses
    # ------------------------------------------------------------------ #
    def compute_losses(self, batch: Dict[str, torch.Tensor], step: int = 0,
                       noise: Optional[Dict[str, Any]] = None,
                       generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The training objective (reference ``generator_loss_fn`` +
        ``discriminator_loss_fn``) at ``step``, with ``noise`` as
        ``draw_noise`` gives it (drawn from ``generator`` when None).

        Returns ``(total, aux)``. One ``total.backward()`` gives the
        generator-side parameters the gradients of the generator losses and
        the discriminators' parameters those of the discriminator losses:
        the discriminator update path sees the fake clip detached, and the
        generator path runs each discriminator on detached parameters and
        matches features against detached real features. ``aux`` holds
        ``outputs``, the ``g_losses`` and ``d_losses`` terms, their sums
        ``g_loss`` and ``d_loss``, and ``new_state["spectral"][key][layer]``,
        the advanced ``u`` of each discriminator from its update path (the
        train step stores them).
        """
        hp = self.hparams
        check_losses_supported(hp)
        batch = normalize_batch(batch)
        images = batch["images"]
        target = images[:, 1:]
        if noise is None:
            noise = self.draw_noise(images.shape[0], images.shape[1], generator, images.device)
        out = self.forward(batch, train=True, step=step, noise=noise)
        gen_images = out["gen_images"]
        recon_images = out.get("gen_images_enc", gen_images)

        g_losses: Dict[str, torch.Tensor] = {}
        d_losses: Dict[str, torch.Tensor] = {}
        if hp.l1_weight:
            g_losses["l1"] = hp.l1_weight * L.l1_loss(recon_images, target)
        if hp.l2_weight:
            g_losses["l2"] = hp.l2_weight * L.l2_loss(recon_images, target)
        if hp.tv_weight:
            g_losses["tv"] = hp.tv_weight * L.total_variation(recon_images)
        if hp.state_weight and "gen_states" in out and batch.get("states") is not None:
            # the posterior rollout's states where the doubled rollout ran
            # (JAX base.py:446-449: none when only the posterior rollout ran)
            g_losses["state"] = hp.state_weight * L.l2_loss(out.get("gen_states_enc", out["gen_states"]),
                                                            batch["states"][:, 1:])
        if self.has_vae and hp.kl_weight:
            anneal = schedules.kl_weight(step, hp)
            g_losses["kl"] = hp.kl_weight * anneal * L.kl_loss(out["zs_mu"], out["zs_logvar"])

        new_spectral: Dict[str, Dict[str, torch.Tensor]] = {}
        if len(self.discriminator):
            start = noise["clip_start"]
            real_clip = self._clip(target, start)

            def run_pair(key: str, fake_frames: torch.Tensor, weight: float, prefix: str) -> None:
                fake_clip = self._clip(fake_frames, start)
                # D update path: real and detached fake in one call; advances u
                both = torch.cat([real_clip, fake_clip.detach()])
                logits_both, feats_both, new_spectral[key] = self.apply_discriminator(key, both, True)
                logits_real, logits_fake = logits_both.chunk(2)
                d_losses[f"{prefix}_real"] = weight * L.gan_loss(logits_real, 1.0, hp.gan_loss_type)
                d_losses[f"{prefix}_fake"] = weight * L.gan_loss(logits_fake, 0.0, hp.gan_loss_type)
                # G update path: detached D parameters, the old u
                logits_g, feats_g, _ = self.apply_discriminator(key, fake_clip, False)
                g_losses[prefix] = weight * L.gan_loss(logits_g, 1.0, hp.gan_loss_type)
                feat_w = hp.vae_gan_feature_l2_weight if key.endswith("_vae") else hp.gan_feature_l2_weight
                if feat_w:
                    feats_real = [f.chunk(2)[0].detach() for f in feats_both]
                    g_losses[prefix + "_feat"] = feat_w * L.feature_matching_loss(feats_real, feats_g)

            if "video" in self.discriminator:
                run_pair("video", gen_images, hp.video_sn_gan_weight, "video_gan")
            if "video_vae" in self.discriminator and "gen_images_enc" in out:
                run_pair("video_vae", out["gen_images_enc"], hp.video_sn_vae_gan_weight, "video_vae_gan")

        zero = torch.zeros((), device=images.device)
        g_total = sum(g_losses.values()) if g_losses else zero
        d_total = sum(d_losses.values()) if d_losses else zero
        aux = {
            "outputs": out,
            "g_losses": g_losses,
            "d_losses": d_losses,
            "g_loss": g_total,
            "d_loss": d_total,
            "new_state": {"spectral": new_spectral} if new_spectral else {},
        }
        return g_total + d_total, aux

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #
    def metrics_fn(self, outputs: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-frame eval metrics on the prediction span (frames
        ``context..T-1``): the means of PSNR, SSIM and MSE, and the PSNR and
        SSIM curves ``[T - context]`` averaged over the batch."""
        ctx = self.hparams.context_frames
        target = normalize_batch(batch)["images"][:, ctx:]
        pred = outputs["gen_images"][:, ctx - 1:]
        psnr = M.peak_signal_to_noise_ratio(target, pred)  # [B, Tp]
        ssim = M.structural_similarity(target, pred)
        mse = M.mean_squared_error(target, pred)
        return {
            "psnr": psnr.mean(),
            "ssim": ssim.mean(),
            "mse": mse.mean(),
            "psnr_per_frame": psnr.mean(dim=0),
            "ssim_per_frame": ssim.mean(dim=0),
        }


class NonTrainableVideoPredictionModel(VideoPredictionModel):
    """Baselines with no parameters (reference ``non_trainable_model.py``).
    Built and called as the trainable model is for evaluation; ``forward``
    ignores ``train`` and the noise arguments. Nothing trains them, so they
    have no losses."""

    trainable = False

    def __init__(self, hparams: ModelHparams, *, image_shape: Sequence[int] = (64, 64, 3), action_dim: int = 0,
                 state_dim: int = 0):
        nn.Module.__init__(self)
        self.hparams = hparams
        self.generator = None
        self.posterior = None
        self.discriminator = nn.ModuleDict()


class GroundTruthVideoPredictionModel(NonTrainableVideoPredictionModel):
    """Outputs the ground-truth future (reference ``GroundTruthVideoPredictionModel``)."""

    name = "ground_truth"

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False, **kw) -> Dict[str, torch.Tensor]:
        return {"gen_images": images_to_float(batch["images"][:, 1:])}


class RepeatVideoPredictionModel(NonTrainableVideoPredictionModel):
    """Repeats the last context frame (reference ``RepeatVideoPredictionModel``):
    frames 1..context-1 are the shifted ground-truth context, frames
    context..T-1 the last context frame."""

    name = "repeat"

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False, **kw) -> Dict[str, torch.Tensor]:
        ctx = self.hparams.context_frames
        images = images_to_float(batch["images"])
        t = images.shape[1]
        rep = images[:, ctx - 1 : ctx].expand(-1, t - ctx, *images.shape[2:])
        return {"gen_images": torch.cat([images[:, 1:ctx], rep], dim=1)}

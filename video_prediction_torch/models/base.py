"""Base video-prediction model: rollouts and loss assembly.

Port of ``video_prediction_tpu/models/base.py`` (reference
``models/base_model.py``): ``images_to_float``, ``normalize_batch``,
``VideoPredictionModel`` with the generator (and, under ``learn_prior``, its
in-cell learned prior), the posterior encoder (per step, or one z per
sequence with ``latent_time_invariant``), the image, video and
action-conditioned SN discriminators and the frozen VGG16 of
``vgg_cdist_weight``; ``forward`` (eval prior rollout, and the training
rollouts: posterior only, or prior and posterior as one doubled batch),
``_clip``, ``apply_discriminator``, ``compute_losses`` (every term of the
JAX package: l1, l2, tv, state, vgg_cdist, kl, z_l1 and each
discriminator's GAN, VAE-GAN and feature-matching terms) and
``metrics_fn``; and the parameter-free baselines
``GroundTruthVideoPredictionModel`` and ``RepeatVideoPredictionModel``.
Every option of the JAX package's ``ModelHparams`` builds; the errors left
are the JAX package's own (``latent_time_invariant`` with ``learn_prior``,
``vgg_cdist_weight`` without weights, the acvideo discriminator without
actions). ``remat``, ``remat_policy`` and ``remat_prevent_cse`` choose
what the generator keeps for the backward pass and what it recomputes, as
in the JAX package (``models/savp.py#recomputes``); the TPU-only knobs
``scan_unroll`` and ``disc_conv3d_taps`` steer how XLA lowers the same
maths; the port accepts them and computes the same result
(``models/savp.py``, ``ops/spectral.py``).

Conventions as in the JAX package: ``batch`` holds ``images [B,T,H,W,C]``
(uint8, or float in [0,1]) and optionally ``actions [B,T or T-1,na]`` and
``states [B,T,ns]`` (read under ``use_states``); ``gen_images
[B,T-1,H,W,C]`` aligns with ``images[:, 1:]``, ``gen_states [B,T-1,ns]``
with ``states[:, 1:]``. Where the JAX
package draws noise from a key, the port takes it as an input (``zs_prior``
for the eval rollout; the ``noise`` dict of ``draw_noise`` for training) or
draws it from an explicit ``torch.Generator``.

Spatial partitioning (``parallel/mesh.py#spatial_context``, the JAX step
traced under ``spatial_trace_mesh``): the batch's images hold this rank's
rows of the height and the generator runs on them. The posterior (and its
``z_l1`` re-encoding), the discriminators' clips and VGG's frames are
gathered to full height (``parallel/spatial.py#gather_rows``) and run whole
on every rank of the spatial group, outside the context (``whole``), where
the JAX package re-constrains them to data parallel
(``constrain_data_parallel``). Each rank's loss is its share of the global
one: the pixel terms (l1, l2, tv) are this rank's sums over the global
count, every term computed whole is weighted 1/k; so the group's sum of
the ranks' gradients is the gradient of the whole loss, and the sum of
their scalars the whole scalars (``train/step.py`` all-reduces both). The
metrics are computed on gathered frames, equal on every rank.

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
from video_prediction_torch.models.networks import (
    ACVideoSNDiscriminator,
    ImageSNDiscriminator,
    PosteriorEncoder,
    VideoSNDiscriminator,
)
from video_prediction_torch.models.savp import SAVPGenerator
from video_prediction_torch.models.vgg import VGGMetric
from video_prediction_torch.ops.rnn import ConvLSTMCell
from video_prediction_torch.ops.spectral import SpectralLayer, l2_normalize
from video_prediction_torch.parallel import spatial as SP
from video_prediction_torch.parallel.mesh import current_spatial, whole
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


# the discriminators by name, in the sorted order the JAX package runs them
DISCRIMINATORS = ("acvideo", "image", "video")
ACVIDEO_NEEDS_ACTIONS = "acvideo_sn_gan_weight requires an action-conditioned dataset"

# flax lecun_normal: truncated normal at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class VideoPredictionModel(nn.Module):
    """Video prediction model (SAVP family): generator plus, when ``nz > 0``,
    the posterior encoder, plus the SN discriminators the GAN weights ask
    for: ``discriminator[name]`` (``image``, ``video``, ``acvideo``) when
    either of its weights is set, run on the prior rollout, and
    ``discriminator[name + "_vae"]`` for the posterior rollout when its
    VAE-GAN weight is (the JAX package's ``params["discriminator"]`` keys).

    ``image_shape`` (H, W, C), ``action_dim`` (0 when the dataset has no
    actions) and ``state_dim`` (0 unless ``use_states`` and the dataset has
    states) fix the parameter shapes, as the first batch does in the JAX
    package's ``init_variables`` (``input_dims``); the discriminators' dense
    layers take the clip of ``min(clip_length, sequence_length - 1)``
    frames. Actions reach the generator whenever the batch has them, even
    under action-free hparams, as in the JAX package.

    ``vgg_cdist_weight`` loads the VGG16 trunk from ``vgg_weights_path``
    (``FileNotFoundError`` without it, as the JAX package) and keeps it
    frozen outside the module tree, as the JAX package keeps it outside
    ``params``: it is in no ``parameters()``, ``state_dict()``, checkpoint
    or optimizer, ``init_weights`` does not reach it, and ``compute_losses``
    moves it to the batch's device. It runs with autograd on, so the loss's
    gradient reaches the generator through it.
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
        h, w, c = image_shape
        clip_shape = (min(hp.clip_length, hp.sequence_length - 1), h, w)
        constructors = {
            "image": lambda: ImageSNDiscriminator(c, (h, w), hp.ndf, dtype),
            "video": lambda: VideoSNDiscriminator(c, clip_shape, hp.ndf, dtype),
            "acvideo": lambda: ACVideoSNDiscriminator(c, action_dim, clip_shape, hp.ndf, dtype),
        }
        for name in DISCRIMINATORS:
            if self._gan_weight(name) or self._vae_gan_weight(name):
                if name == "acvideo" and not action_dim:
                    raise ValueError(f"{ACVIDEO_NEEDS_ACTIONS} (the model was built with action_dim=0)")
                self.discriminator[name] = constructors[name]()
                if self._vae_gan_weight(name):
                    self.discriminator[name + "_vae"] = constructors[name]()
        # a plain object, not a module: outside parameters() and state_dict()
        self.vgg = VGGMetric(hp.vgg_weights_path or None) if hp.vgg_cdist_weight else None

    @classmethod
    def default_hparams(cls) -> ModelHparams:
        """The base-model defaults; the zoo classes override them."""
        return ModelHparams()

    @property
    def has_vae(self) -> bool:
        return self.hparams.nz > 0

    def _gan_weight(self, name: str) -> float:
        return getattr(self.hparams, f"{name}_sn_gan_weight")

    def _vae_gan_weight(self, name: str) -> float:
        return getattr(self.hparams, f"{name}_sn_vae_gan_weight")

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Initialize as flax does: lecun-normal conv and dense kernels (zero
        where the layer asks, ``Dense(zero_init=True)``), the same on the
        JAX-layout kernels of ``Local2D`` and ``SeparableLocal2D`` (flax's
        ``variance_scaling(1, "fan_in", "truncated_normal")``, fan-in the
        product of every axis but the last), zero biases and learned initial
        states, unit norm scales (ConvLSTM ``ln`` rows: scale 1, bias 0), and
        each spectral ``u`` a normalized Gaussian draw."""
        for module in self.modules():
            for name, p in module.named_parameters(recurse=False):
                if name == "weight" and getattr(module, "zero_init", False):
                    p.zero_()
                elif name in ("weight", "kernel", "vertical", "horizontal"):
                    # PyTorch layouts (conv OI..., dense [out, in]) put the output axis
                    # first, the JAX-layout kernels last
                    fan_in = math.prod(p.shape[1:] if name == "weight" else p.shape[:-1])
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
        ``latent_time_invariant``, when stochastic; under ``learn_prior``
        ``z_p`` is the learned prior's reparameterization noise, as the JAX
        package's ``eps_p`` takes the same key) and the start of the
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
        step: int | torch.Tensor = 0,
        noise: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Generator-side forward.

        Eval (``train=False``): returns ``gen_images`` of the prior rollout
        and, when stochastic, ``zs_mu``/``zs_logvar`` from the posterior and
        the prior draws ``zs_sampled_prior`` that drove it. ``zs_prior``
        ``[B,T-1,nz]`` (``[B,1,nz]`` with ``latent_time_invariant``: one z
        per sequence, broadcast over the rollout) is used as given; otherwise
        it is drawn from ``generator`` (a ``torch.Generator`` on the batch's
        device). Under ``learn_prior`` it is the learned prior's
        reparameterization noise instead, and the rollout also returns
        ``prior_mu``/``prior_logvar``, with ``zs_sampled_prior`` the z the
        cell took. The latent statistics stay un-broadcast, so the KL sees
        the sequence-level quantities.

        Train: the teacher-forcing mask is sampled at ``step`` (an int, or a
        0-d device tensor that only the schedules read) from
        ``noise["use_gt_u"]`` and the posterior z is ``mu + exp(logvar/2) *
        noise["eps_q"]`` (``noise`` as ``draw_noise`` gives it, drawn from
        ``generator`` when None). When a loss needs the prior rollout (a GAN
        weight on it, or ``z_l1_weight``; JAX ``base.py:302-306``) the prior
        (``noise["z_p"]``, or the learned prior with it as noise) and
        posterior rollouts run as one generator call on a doubled batch and
        come back as ``gen_images`` and ``gen_images_enc``; otherwise only
        the posterior rollout runs and ``gen_images`` is it. Under
        ``learn_prior`` ``prior_mu``/``prior_logvar`` are those of the
        posterior rollout, which conditions on the frames the posterior sees
        (JAX ``base.py:358-368``), and ``zs_sampled_prior`` the prior
        rollout's z.
        """
        hp = self.hparams
        batch = normalize_batch(batch)
        images = batch["images"]
        b, t = images.shape[:2]
        gen_kwargs = self._generator_kwargs(batch)
        if train:
            if noise is None:
                noise = self.draw_noise(b, t, generator, images.device)
            use_gt = schedules.sample_use_gt_mask(b, t, hp, True, images.device, step, noise["use_gt_u"],
                                                  noise.get("use_gt_rank"), noise.get("use_gt_batch"))
        else:
            use_gt = schedules.sample_use_gt_mask(b, t, hp, False, device=images.device)

        if not self.has_vae:
            return dict(self.generator(images, use_gt, output_aux=output_aux, **gen_kwargs))

        out: Dict[str, torch.Tensor] = {}
        mu_q, logvar_q = self._posterior(images)
        out["zs_mu"], out["zs_logvar"] = mu_q, logvar_q
        learn_prior = bool(hp.learn_prior)

        def bz(z: torch.Tensor) -> torch.Tensor:  # a sequence-level z over every rollout step
            return z.expand(z.shape[0], t - 1, hp.nz)

        if not train:
            if zs_prior is None:
                zs_prior = torch.randn(mu_q.shape, generator=generator, device=images.device)
            elif tuple(zs_prior.shape) != tuple(mu_q.shape):
                raise ValueError(f"zs_prior must be {tuple(mu_q.shape)}, got {tuple(zs_prior.shape)}")
            if learn_prior:
                out.update(self.generator(images, use_gt, prior_eps=zs_prior, output_aux=output_aux, **gen_kwargs))
            else:
                out["zs_sampled_prior"] = zs_prior
                out.update(self.generator(images, use_gt, zs=bz(zs_prior), output_aux=output_aux, **gen_kwargs))
            return self._canonical_prior(out)

        z_q = mu_q + torch.exp(0.5 * logvar_q) * noise["eps_q"]
        z_p = noise["z_p"]  # under learn_prior: the prior's reparameterization noise
        if not learn_prior:
            out["zs_sampled_prior"] = z_p
        need_prior_rollout = hp.z_l1_weight > 0 or any(self._gan_weight(name) for name in DISCRIMINATORS)
        if need_prior_rollout:
            # the prior and posterior rollouts as one doubled batch
            kwargs2 = {k: torch.cat([v, v]) for k, v in gen_kwargs.items()}
            if learn_prior:
                # first half: the in-cell prior's z; second half: the posterior's
                zs2 = torch.cat([torch.zeros_like(z_q), z_q])
                kwargs2["prior_eps"] = torch.cat([z_p, torch.zeros_like(z_p)])
                kwargs2["use_prior_z"] = torch.arange(2 * b, device=images.device) < b
            else:
                zs2 = torch.cat([bz(z_p), bz(z_q)])
            gout = self.generator(torch.cat([images, images]), torch.cat([use_gt, use_gt], dim=1), zs=zs2,
                                  output_aux=output_aux, **kwargs2)
            for k, v in gout.items():
                out[k], out[k + "_enc"] = v[:b], v[b:]
        else:
            gout = self.generator(images, use_gt, zs=bz(z_q), output_aux=output_aux, **gen_kwargs)
            out.update({k + "_enc": v for k, v in gout.items()})
            out["gen_images"] = gout["gen_images"]  # the posterior rollout doubles as the main output
        return self._canonical_prior(out)

    def _posterior(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The posterior encoder on ``images [B,T,H,W,C]``, gathered to full
        height and run whole under a spatial context."""
        full = SP.gathered(images, dim=2)
        with whole():
            return self.posterior(full)

    def _canonical_prior(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The learned prior's outputs under the names the losses read (JAX
        ``base.py:358-368``): the posterior rollout's ``prior_*_enc`` as
        ``prior_*`` where it ran, the prior rollout's ``z_used`` as
        ``zs_sampled_prior``."""
        if not self.hparams.learn_prior:
            return out
        if "prior_mu_enc" in out:
            out["prior_mu"] = out.pop("prior_mu_enc")
            out["prior_logvar"] = out.pop("prior_logvar_enc")
        if "z_used" in out:
            out["zs_sampled_prior"] = out.pop("z_used")
        out.pop("z_used_enc", None)
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

    @staticmethod
    def _transition_actions(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The actions aligned with the target frames ``images[:, 1:]`` (action
        t drives the t -> t+1 transition): the acvideo discriminator's input."""
        actions = batch.get("actions")
        if actions is None:
            raise ValueError(f"{ACVIDEO_NEEDS_ACTIONS} (batch has no 'actions')")
        return actions[:, : batch["images"].shape[1] - 1]

    def apply_discriminator(self, key: str, clips: torch.Tensor, update_spectral: bool,
                            extra: Tuple[torch.Tensor, ...] = ()
                            ) -> Tuple[torch.Tensor, List[torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
        """Run ``discriminator[key]`` on ``clips`` and the ``extra`` inputs
        (the acvideo discriminator's action clip): ``(logits, features,
        new_u)``. With ``update_spectral`` the discriminator's own parameters
        take gradients and the advanced ``u`` vectors come back; without, it
        runs on detached parameters (its gradients flow only into the
        inputs) from the same stored ``u``, and ``new_u`` is None. The clips
        are whole (gathered under a spatial context): it runs outside one."""
        disc = self.discriminator[key]
        with whole():
            if update_spectral:
                return disc(clips, *extra)
            params = {name: p.detach() for name, p in disc.named_parameters()}
            logits, feats, _ = torch.func.functional_call(disc, params, (clips, *extra))
        return logits, feats, None

    # ------------------------------------------------------------------ #
    # losses
    # ------------------------------------------------------------------ #
    def compute_losses(self, batch: Dict[str, torch.Tensor], step: int | torch.Tensor = 0,
                       noise: Optional[Dict[str, Any]] = None,
                       generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The training objective (reference ``generator_loss_fn`` +
        ``discriminator_loss_fn``) at ``step`` (an int, or a 0-d device
        tensor: the KL anneal and the mask's schedule then stay on the
        device, and nothing is read back to the host), with ``noise`` as
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

        The terms, in the JAX package's order (``base.py:419-531``): l1, l2,
        tv and state on the posterior rollout; ``vgg_cdist``, ``weight *
        mean(1 - VGG cosine(recon, target))``; the KL against the unit
        Gaussian or, under ``learn_prior``, the learned prior's statistics;
        ``z_l1``, the L1 between the posterior mean of the prior rollout's
        frames (re-encoded after the first ground-truth frame) and the z that
        made them; then for each discriminator in sorted order its GAN
        terms on the prior rollout and its ``_vae`` twin's on the posterior
        rollout.
        """
        hp = self.hparams
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
        mesh = current_spatial()
        if hp.tv_weight:
            g_losses["tv"] = hp.tv_weight * (L.total_variation(recon_images) if mesh is None else
                                             L.total_variation_share(recon_images, mesh))
        if hp.state_weight and "gen_states" in out and batch.get("states") is not None:
            # the posterior rollout's states where the doubled rollout ran
            # (JAX base.py:446-449: none when only the posterior rollout ran)
            g_losses["state"] = hp.state_weight * L.l2_loss(out.get("gen_states_enc", out["gen_states"]),
                                                            batch["states"][:, 1:])
        if self.vgg is not None:
            self.vgg.module.to(images.device)  # a no-op once there
            recon_full, target_full = SP.gathered(recon_images, dim=2), SP.gathered(target, dim=2)
            with whole():
                g_losses["vgg_cdist"] = hp.vgg_cdist_weight * (1.0 - self.vgg(recon_full, target_full)).mean()
        if self.has_vae and hp.kl_weight:
            anneal = schedules.kl_weight(step, hp)
            g_losses["kl"] = hp.kl_weight * anneal * L.kl_loss(out["zs_mu"], out["zs_logvar"],
                                                               out.get("prior_mu"), out.get("prior_logvar"))
        if self.has_vae and hp.z_l1_weight:
            # the latent cycle: the prior rollout re-encoded (after ground-truth
            # frame 0) gives back the z that made it (JAX base.py:464-473)
            mu_hat, _ = self._posterior(torch.cat([images[:, :1], gen_images], dim=1))
            g_losses["z_l1"] = hp.z_l1_weight * L.l1_loss(mu_hat, out["zs_sampled_prior"])

        new_spectral: Dict[str, Dict[str, torch.Tensor]] = {}
        if len(self.discriminator):
            start = noise["clip_start"]
            real_clip = SP.gathered(self._clip(target, start), dim=2)

            def run_pair(key: str, fake_frames: torch.Tensor, weight: float, prefix: str) -> None:
                fake_clip = SP.gathered(self._clip(fake_frames, start), dim=2)
                extra = (self._clip(self._transition_actions(batch), start),) if key.startswith("acvideo") else ()
                # D update path: real and detached fake in one call; advances u
                both = torch.cat([real_clip, fake_clip.detach()])
                logits_both, feats_both, new_spectral[key] = self.apply_discriminator(
                    key, both, True, tuple(torch.cat([e, e]) for e in extra))
                logits_real, logits_fake = logits_both.chunk(2)
                d_losses[f"{prefix}_real"] = weight * L.gan_loss(logits_real, 1.0, hp.gan_loss_type)
                d_losses[f"{prefix}_fake"] = weight * L.gan_loss(logits_fake, 0.0, hp.gan_loss_type)
                # G update path: detached D parameters, the old u
                logits_g, feats_g, _ = self.apply_discriminator(key, fake_clip, False, extra)
                g_losses[prefix] = weight * L.gan_loss(logits_g, 1.0, hp.gan_loss_type)
                feat_w = hp.vae_gan_feature_l2_weight if key.endswith("_vae") else hp.gan_feature_l2_weight
                if feat_w:
                    feats_real = [f.chunk(2)[0].detach() for f in feats_both]
                    g_losses[prefix + "_feat"] = feat_w * L.feature_matching_loss(feats_real, feats_g)

            for name in DISCRIMINATORS:  # sorted, as the JAX package runs them
                if name in self.discriminator and self._gan_weight(name):
                    run_pair(name, gen_images, self._gan_weight(name), f"{name}_gan")
                if name + "_vae" in self.discriminator and "gen_images_enc" in out:
                    run_pair(name + "_vae", out["gen_images_enc"], self._vae_gan_weight(name), f"{name}_vae_gan")

        if mesh is not None:  # this rank's shares (tv's is its own)
            g_losses = {k: v if k == "tv" else v / mesh.k for k, v in g_losses.items()}
            d_losses = {k: v / mesh.k for k, v in d_losses.items()}
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
        target = SP.gathered(normalize_batch(batch)["images"][:, ctx:], dim=2)
        pred = SP.gathered(outputs["gen_images"][:, ctx - 1:], dim=2)
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

"""Concrete model classes of the reference zoo.

Port of ``video_prediction_tpu/models/model_zoo.py``: ``savp``, ``dna``,
``sna`` and ``sv2p``, each the shared generator and losses under its own
default hparams (the reference keeps four generator implementations whose
differences are these knobs).
"""

from __future__ import annotations

from video_prediction_torch.configs.hparams import ModelHparams
from video_prediction_torch.models.base import VideoPredictionModel


class SAVPVideoPredictionModel(VideoPredictionModel):
    """Stochastic Adversarial Video Prediction (Lee et al. 2018).

    Reference: ``models/savp_model.py#SAVPVideoPredictionModel``. Defaults
    correspond to the deterministic generator; the hparams zoo turns on the
    VAE / GAN / VAE-GAN objectives.
    """

    name = "savp"

    @classmethod
    def default_hparams(cls) -> ModelHparams:
        return ModelHparams(
            l1_weight=1.0,
            kl_weight=0.0,
            nz=0,
            transformation="cdna",
            num_transformed_images=4,
            first_image_background=True,
            prev_image_background=True,
            generate_scratch_image=True,
            dependent_mask=True,
            schedule_sampling="inverse_sigmoid",
            schedule_sampling_k=900.0,
        )


class DNAVideoPredictionModel(VideoPredictionModel):
    """Finn et al. 2016 action-conditioned DNA/CDNA predictor.

    Reference: ``models/dna_model.py#DNAVideoPredictionModel``.
    """

    name = "dna"

    @classmethod
    def default_hparams(cls) -> ModelHparams:
        return ModelHparams(
            l1_weight=0.0,
            l2_weight=1.0,
            nz=0,
            transformation="dna",
            kernel_normalization="relu",  # Finn 2016 relu-normalized kernels
            num_transformed_images=0,
            first_image_background=False,
            prev_image_background=True,
            generate_scratch_image=True,
            dependent_mask=False,
            schedule_sampling="inverse_sigmoid",
            schedule_sampling_k=900.0,
            use_states=True,
            state_weight=1e-4,
        )


class SNAVideoPredictionModel(VideoPredictionModel):
    """Ebert et al. 2017 skip-connection neural advection (occlusion-aware).

    Reference: ``models/sna_model.py#SNAVideoPredictionModel``.
    """

    name = "sna"

    @classmethod
    def default_hparams(cls) -> ModelHparams:
        return ModelHparams(
            l1_weight=0.0,
            l2_weight=1.0,
            nz=0,
            transformation="cdna",
            kernel_normalization="relu",  # Finn-style CDNA normalization
            num_transformed_images=4,
            first_image_background=True,  # the defining SNA skip
            prev_image_background=True,
            generate_scratch_image=True,
            dependent_mask=False,
            schedule_sampling="inverse_sigmoid",
            schedule_sampling_k=900.0,
            use_states=True,
            state_weight=1e-4,
        )


class SV2PVideoPredictionModel(VideoPredictionModel):
    """Babaeizadeh et al. 2018 stochastic variational video prediction.

    Reference: ``models/sv2p_model.py#SV2PVideoPredictionModel``: the CDNA
    generator with a time-invariant latent posterior (one z per sequence,
    encoded from the whole clip, ``latent_time_invariant=True``), a
    KL-annealed ELBO and no adversary.
    """

    name = "sv2p"

    @classmethod
    def default_hparams(cls) -> ModelHparams:
        return ModelHparams(
            l1_weight=0.0,
            l2_weight=1.0,
            nz=8,
            latent_time_invariant=True,
            kl_weight=1e-3,
            kl_anneal="linear",
            kl_anneal_steps=(100000, 200000),
            transformation="cdna",
            num_transformed_images=4,
            first_image_background=False,
            prev_image_background=True,
            generate_scratch_image=True,
            dependent_mask=False,
            where_add="middle",
            schedule_sampling="inverse_sigmoid",
            schedule_sampling_k=900.0,
        )

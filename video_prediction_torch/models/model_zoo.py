"""Concrete model classes of the reference zoo.

Port of ``video_prediction_tpu/models/model_zoo.py``. The port has ``savp``
and ``sv2p``; ``dna`` and ``sna`` need the ``dna`` transformation and the
state head, which are still to be ported (ROADMAP.md).
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

"""Hyperparameter system: dataclasses + JSON zoo + ``k=v`` override strings.

A copy of ``video_prediction_tpu/configs/hparams.py``. It is copied, not
imported, because importing anything from ``video_prediction_tpu`` runs that
package's ``__init__``, which imports jax. ``tests/test_torch_configs.py``
keeps the two copies equal: field names, defaults, allowed values and the
override parser.

Three-tier merge, as in the reference (``models/base_model.py#
get_default_hparams_dict`` -> ``--model_hparams_dict`` JSON file ->
``--model_hparams`` comma-separated string): model-class defaults, then a
JSON file from the ``hparams/<dataset>/<variant>/`` zoo, then CLI overrides.
Types are validated against the dataclass field; list-valued fields accept
both JSON lists and the reference's ``[a, b]`` string syntax.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Tuple


@dataclasses.dataclass
class ModelHparams:
    """Union of the base-model and SAVP-family hyperparameters; field names
    follow the reference hparams zoo. The port runs a subset of them (see
    ``models/savp.py``); the rest are accepted so that every zoo file and
    saved run directory parses."""

    # --- sequence structure ---
    context_frames: int = 2
    sequence_length: int = 12
    # --- optimization (base_model) ---
    batch_size: int = 16
    lr: float = 0.001
    end_lr: float = 0.0
    decay_steps: Tuple[int, int] = (200000, 300000)
    beta1: float = 0.9
    beta2: float = 0.999
    max_steps: int = 300000
    # --- reconstruction losses ---
    l1_weight: float = 0.0
    l2_weight: float = 0.0
    vgg_cdist_weight: float = 0.0
    state_weight: float = 0.0
    tv_weight: float = 0.0
    # --- GAN losses ---
    gan_loss_type: str = "LSGAN"
    image_sn_gan_weight: float = 0.0
    image_sn_vae_gan_weight: float = 0.0
    video_sn_gan_weight: float = 0.0
    video_sn_vae_gan_weight: float = 0.0
    # action-conditioned video discriminator
    acvideo_sn_gan_weight: float = 0.0
    acvideo_sn_vae_gan_weight: float = 0.0
    gan_feature_l2_weight: float = 0.0
    vae_gan_feature_l2_weight: float = 0.0
    clip_length: int = 10
    ndf: int = 32
    # --- VAE losses / latent ---
    kl_weight: float = 0.0
    kl_anneal: str = "linear"  # none | sigmoid | linear
    kl_anneal_k: float = -1.0
    kl_anneal_steps: Tuple[int, int] = (50000, 100000)
    z_l1_weight: float = 0.0
    nz: int = 8
    nef: int = 64
    learn_prior: bool = False
    # one z per sequence (SV2P) instead of the per-step frame-pair posterior
    latent_time_invariant: bool = False
    # --- generator architecture (savp_model) ---
    ngf: int = 32
    downsample_layer: str = "conv_pool2d"
    upsample_layer: str = "upsample_conv2d"
    norm_layer: str = "instance"
    activation_layer: str = "relu"
    conv_rnn: str = "lstm"  # lstm | gru
    conv_rnn_norm: bool = True  # layer-norm inside the ConvLSTM cells
    learn_initial_state: bool = False  # learned (vs zero) ConvRNN init states
    vgg_weights_path: str = ""  # VGG16 .npz for vgg_cdist_weight / eval csim
    transformation: str = "cdna"  # cdna | dna | stp | flow | direct
    # CDNA/DNA kernel normalization over the spatial taps: "softmax" (SAVP)
    # or "relu" (Finn et al. 2016 relu-then-divide)
    kernel_normalization: str = "softmax"
    kernel_size: Tuple[int, int] = (5, 5)
    num_transformed_images: int = 4
    last_frames: int = 1
    prev_image_background: bool = True
    first_image_background: bool = True
    context_images_background: bool = False  # all context frames as candidates
    generate_scratch_image: bool = True
    dependent_mask: bool = True
    where_add: str = "all"  # all | input | middle
    # --- scheduled sampling ---
    schedule_sampling: str = "inverse_sigmoid"  # none | inverse_sigmoid | linear
    schedule_sampling_k: float = 900.0
    schedule_sampling_steps: Tuple[int, int] = (0, 100000)
    # exact-count teacher forcing (round(p*B) ground-truth samples per step)
    # instead of i.i.d. bernoulli(p)
    schedule_sampling_exact: bool = False
    # --- action/state conditioning ---
    use_states: bool = False
    # --- numerics / memory ---
    compute_dtype: str = "float32"  # float32 | bfloat16
    # recompute the generator cell in the backward pass (remat_policy
    # "full": the whole cell; "names": all but the marked conv/ConvRNN
    # outputs) where remat and (scan_unroll != 0 or remat_prevent_cse), as
    # the JAX package's scan does (models/savp.py#recomputes); scan_unroll
    # otherwise only picks the dependent mask head's form
    remat: bool = True
    remat_policy: str = "full"  # full | names
    remat_prevent_cse: bool = False
    scan_unroll: int = 1
    # ConvLSTM gate-conv layout: "merged" = one conv over concat([x, h]);
    # "split" = separate x/h convs + add. Param trees differ, so a checkpoint
    # is tied to its layout; the default stays "split" for the run
    # directories whose saved hparams predate the field.
    lstm_gate_conv: str = "split"  # merged | split
    # dtype of the ConvLSTM gate maths (LN, sigmoid/tanh, cell update)
    gate_dtype: str = "float32"  # float32 | bfloat16
    # video-discriminator conv3d as time-shifted 2-D convs (same maths)
    disc_conv3d_taps: bool = False

    # Enum-valued fields, validated at construction: the one choke point
    # every construction path (defaults, JSON zoo, k=v overrides, replace())
    # goes through, so a typo never silently selects a default.
    _ALLOWED = {
        "gan_loss_type": ("GAN", "LSGAN", "hinge"),
        "kl_anneal": ("none", "sigmoid", "linear"),
        "conv_rnn": ("lstm", "gru"),
        "transformation": ("cdna", "dna", "stp", "flow", "direct"),
        "kernel_normalization": ("softmax", "relu"),
        "where_add": ("all", "input", "middle"),
        "schedule_sampling": ("none", "inverse_sigmoid", "linear", "always"),
        "compute_dtype": ("float32", "bfloat16"),
        "remat_policy": ("full", "names"),
        "lstm_gate_conv": ("merged", "split"),
        "gate_dtype": ("float32", "bfloat16"),
    }

    def __post_init__(self):
        for field, allowed in self._ALLOWED.items():
            value = getattr(self, field)
            if value not in allowed:
                raise ValueError(
                    f"{field}={value!r} is not one of {sorted(allowed)}"
                )

    def replace(self, **kw) -> "ModelHparams":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        # _ALLOWED has no annotation -> not a dataclass field -> not in asdict
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DatasetHparams:
    """Dataset-side hyperparameters (reference ``datasets/base_dataset.py``)."""

    context_frames: int = 2
    sequence_length: int = 12
    long_sequence_length: int = 30
    # quantum of the random start offset of the contiguous
    # sequence_length window (train); eval windows start at 0
    time_shift: int = 1
    use_state: bool = False
    shuffle_on_val: bool = False
    crop_size: int = 0
    scale_size: int = 0

    def replace(self, **kw) -> "DatasetHparams":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _coerce(value: Any, field_type: Any) -> Any:
    """Coerce a parsed value to a dataclass field's type."""
    origin = getattr(field_type, "__origin__", None)
    if origin in (tuple, Tuple) or field_type in (tuple,):
        return tuple(value)
    if field_type is bool and isinstance(value, (int, str)):
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes")
        return bool(value)
    if field_type is float and isinstance(value, int):
        return float(value)
    return value


def parse_overrides(spec: str) -> Dict[str, Any]:
    """Parse ``"k1=v1,k2=v2"`` override strings (HParams.parse-compatible).

    Values are python/JSON literals; bare words become strings. List values
    may use ``[a, b]`` — commas inside brackets are handled.
    """
    out: Dict[str, Any] = {}
    if not spec:
        return out
    # split on commas not inside brackets
    items, depth, cur = [], 0, ""
    for ch in spec:
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        if ch == "," and depth == 0:
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur)
    for item in items:
        if not item.strip():
            continue
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        k, v = item.split("=", 1)
        k, v = k.strip(), v.strip()
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v  # bare string
    return out


def apply_overrides(hparams, overrides: Dict[str, Any]):
    """Apply a dict of overrides to a dataclass instance with type coercion.

    Unknown keys raise (same strictness as ``HParams.parse``).
    """
    fields = {f.name: f for f in dataclasses.fields(hparams)}
    kw = {}
    for k, v in overrides.items():
        if k not in fields:
            raise ValueError(
                f"unknown hparam {k!r} for {type(hparams).__name__}; known: {sorted(fields)}"
            )
        kw[k] = _coerce(v, _resolve_type(fields[k]))
    return hparams.replace(**kw)


def adopt_inference_defaults(hp: ModelHparams, user_overrides: Dict[str, Any]) -> ModelHparams:
    """Inference-side operating point for restored hparams.

    The JAX package switches the restored run to a fully unrolled time scan
    here. The port runs its time loop in Python and lowers no scan, so there
    is nothing to adopt: ``hp`` comes back unchanged. Kept so that the
    generation entry point reads like the JAX one.
    """
    return hp


def _resolve_type(field: dataclasses.Field):
    t = field.type
    if isinstance(t, str):
        # from __future__ annotations: resolve common cases
        base = t.split("[")[0]
        return {"int": int, "float": float, "bool": bool, "str": str, "Tuple": tuple, "tuple": tuple}.get(base, str)
    return t


def load_hparams_json(path: str | Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def zoo_dir() -> Path:
    """Root of the bundled hparams zoo (mirrors reference ``hparams/``)."""
    return Path(__file__).resolve().parent.parent.parent / "hparams"


def resolve_model_hparams(
    defaults: ModelHparams,
    hparams_dict_path: str | None = None,
    hparams_str: str | None = None,
    extra: Dict[str, Any] | None = None,
) -> ModelHparams:
    """Three-tier merge: defaults -> JSON file -> override string -> extra."""
    hp = defaults
    if hparams_dict_path:
        hp = apply_overrides(hp, load_hparams_json(hparams_dict_path))
    if hparams_str:
        hp = apply_overrides(hp, parse_overrides(hparams_str))
    if extra:
        hp = apply_overrides(hp, extra)
    return hp

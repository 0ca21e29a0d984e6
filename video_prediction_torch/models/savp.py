"""SAVP generator: ConvLSTM encoder-decoder with CDNA transformation kernels
and masked compositing.

Port of ``video_prediction_tpu/models/savp.py`` (``SAVPCell``,
``SAVPGenerator``, ``generator_num_scales``; reference ``savp_model.py``).
The JAX package scans the cell over time with ``nn.scan``; here the time
loop is a Python loop. Per step the cell calls kernel K1 once (CDNA,
``ops/cdna.py``), kernel K2 once per ConvLSTM cell (``ops/rnn.py``) and
kernel K3 once (compositing, ``kernels/composite.py``).

Ported: the ``cdna`` transformation, the ``prev``/``first``/``scratch``
backgrounds, dependent and independent masks, ``where_add``, action
conditioning, LSTM cells with or without LayerNorm, fp32 compute. The other
transformations, ``learn_prior``, ``use_states``, ``learn_initial_state``,
``context_images_background``, GRU cells and bf16 compute raise
``NotImplementedError`` (ROADMAP.md, queue 1). ``remat``, ``remat_policy``,
``remat_prevent_cse`` and ``scan_unroll`` steer how JAX lowers its scan;
they mean nothing to a Python loop and are ignored. The JAX package's two
compositing forms (fused sum and einsum, ``savp.py:364-390``) are the same
maths with the same parameters; both are K3 here.

Module names follow the flax parameter tree (``stem``, ``down1``,
``enc_rnn1``, ..., ``mask_head``) so that ``convert.py`` maps it directly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from video_prediction_torch.configs.hparams import ModelHparams
from video_prediction_torch.kernels.composite import composite
from video_prediction_torch.ops.cdna import apply_cdna_kernels, normalize_kernels
from video_prediction_torch.ops.layers import (
    Conv2D,
    get_activation,
    get_downsample_layer,
    get_norm_layer,
    get_upsample_layer,
    tile_concat,
)
from video_prediction_torch.ops.rnn import ConvLSTMCell

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1)"


def _static_log2(n: int) -> int:
    k = 0
    while (1 << (k + 1)) <= n:
        k += 1
    return k


def generator_num_scales(height: int, width: int) -> int:
    """Encoder/decoder scale count for an input resolution: bottleneck at
    8x8 — 3 scales for 64 px, 4 for 128 px, at least 1."""
    return max(1, min(4, _static_log2(min(height, width)) - 3))


def check_supported(hp: ModelHparams) -> None:
    """Raise ``NotImplementedError`` for hparams outside the ported slice."""
    unsupported = {
        "transformation": hp.transformation != "cdna",
        "learn_prior": hp.learn_prior,
        "use_states": hp.use_states,
        "learn_initial_state": hp.learn_initial_state,
        "context_images_background": hp.context_images_background,
        "conv_rnn": hp.conv_rnn != "lstm",
        "compute_dtype": hp.compute_dtype != "float32",
        "gate_dtype": hp.gate_dtype != "float32",
    }
    for name, bad in unsupported.items():
        if bad:
            raise NotImplementedError(f"{name}={getattr(hp, name)!r} {_NOT_PORTED}")


class SAVPCell(nn.Module):
    """One generator timestep (reference ``savp_model.py#SAVPCell.call``).

    state = (rnn_states, gen_image, last_images)
    x     = {image, use_gt, first_image, z?, action?}
    out   = {gen_image, masks?, kernels?}
    """

    def __init__(self, hparams: ModelHparams, num_scales: int, image_channels: int, action_dim: int = 0):
        super().__init__()
        check_supported(hparams)
        hp = self.hparams = hparams
        self.num_scales = num_scales
        ngf, c = hp.ngf, image_channels
        self.action_dim = action_dim
        z_dim = hp.nz if hp.nz > 0 else 0
        z_all = z_dim if hp.where_add == "all" else 0
        norm = get_norm_layer(hp.norm_layer)
        down = get_downsample_layer(hp.downsample_layer)
        up = get_upsample_layer(hp.upsample_layer)
        self.act = get_activation(hp.activation_layer)

        def rnn(in_features: int, features: int) -> ConvLSTMCell:
            return ConvLSTMCell(in_features, features, use_norm=hp.conv_rnn_norm, gate_conv=hp.lstm_gate_conv)

        # channel order of every concat follows savp.py: input = image, cond,
        # z (:228-232); encoder level = h, z, cond (:251-254); decoder = up(h),
        # skip, z (:268-270)
        stem_in = c + action_dim + (z_dim if hp.where_add in ("input", "all") else 0)
        self.stem = Conv2D(stem_in, ngf, 3)
        self.stem_norm = norm(ngf)
        for s in range(1, num_scales + 1):
            feats = ngf * 2**s
            self.add_module(f"down{s}", down(feats // 2, feats))
            self.add_module(f"down{s}_norm", norm(feats))
            cond_all = action_dim if hp.where_add == "all" else 0
            self.add_module(f"enc_rnn{s}", rnn(feats + z_all + cond_all, feats))
        for s in range(num_scales - 1, -1, -1):
            feats = ngf * 2**s
            self.add_module(f"up{s}", up(2 * feats, feats))
            self.add_module(f"up{s}_norm", norm(feats))
            z_dec = z_dim if hp.where_add in ("all", "middle") else 0
            self.add_module(f"dec_rnn{s}", rnn(2 * feats + z_dec, feats))

        kh, kw = hp.kernel_size
        n_trans = hp.num_transformed_images
        num_masks = 0
        if n_trans > 0:
            # GAP over the bottleneck, then Dense(kh*kw*N) (savp.py:283-289)
            self.cdna_head = nn.Linear(ngf * 2**num_scales, kh * kw * n_trans)
            num_masks += n_trans * hp.last_frames
        num_masks += int(hp.prev_image_background) + int(hp.first_image_background)
        self.has_scratch = hp.generate_scratch_image or num_masks == 0
        if self.has_scratch:
            self.scratch_head = Conv2D(ngf, c, 3)
            num_masks += 1
        self.num_masks = num_masks
        if num_masks > 1:
            mask_in = ngf + num_masks * c if hp.dependent_mask else ngf
            self.mask_head = Conv2D(mask_in, num_masks, 3)

    def rnn_cells(self) -> List[ConvLSTMCell]:
        """Encoder cells (scales 1..S), then decoder cells (scales S-1..0)."""
        enc = [getattr(self, f"enc_rnn{s}") for s in range(1, self.num_scales + 1)]
        dec = [getattr(self, f"dec_rnn{s}") for s in range(self.num_scales - 1, -1, -1)]
        return enc + dec

    def init_rnn_states(self, batch: int, height: int, width: int, device: torch.device) -> list:
        scales = list(range(1, self.num_scales + 1)) + list(range(self.num_scales - 1, -1, -1))
        return [
            cell.initial_state(batch, height // 2**s, width // 2**s, device)
            for cell, s in zip(self.rnn_cells(), scales)
        ]

    def forward(self, state: Tuple[list, torch.Tensor, list], x: Dict[str, torch.Tensor],
                output_aux: bool = False):
        hp = self.hparams
        rnn_states, gen_image, last_images = state
        use_gt = x["use_gt"]  # [B] bool
        image = torch.where(use_gt[:, None, None, None], x["image"], gen_image)
        b, hgt, wid, c = image.shape
        last_images = last_images[1:] + [image]  # the last `last_frames` inputs
        aux: Dict[str, torch.Tensor] = {}

        z = x.get("z")
        cond = x.get("action")
        inputs = image
        if cond is not None:
            inputs = tile_concat(inputs, cond)
        if z is not None and hp.where_add in ("input", "all"):
            inputs = tile_concat(inputs, z)

        # ---- encoder ----
        cells = iter(self.rnn_cells())
        new_states = []
        h = self.act(self.stem_norm(self.stem(inputs)))
        skips = [h]
        for s in range(1, self.num_scales + 1):
            h = self.act(getattr(self, f"down{s}_norm")(getattr(self, f"down{s}")(h)))
            if z is not None and hp.where_add == "all":
                h = tile_concat(h, z)
            if cond is not None and hp.where_add == "all":
                h = tile_concat(h, cond)
            st, h = next(cells)(rnn_states[len(new_states)], h)
            new_states.append(st)
            skips.append(h)
        bottleneck = h

        # ---- decoder ----
        for s in range(self.num_scales - 1, -1, -1):
            h = self.act(getattr(self, f"up{s}_norm")(getattr(self, f"up{s}")(h)))
            h = torch.cat([h, skips[s]], dim=-1)
            if z is not None and hp.where_add in ("all", "middle"):
                h = tile_concat(h, z)
            st, h = next(cells)(rnn_states[len(new_states)], h)
            new_states.append(st)
        feat_top = h

        # ---- candidates, in savp.py's order: cdna x N, prev, first, scratch ----
        parts = []
        if hp.num_transformed_images > 0:
            kh, kw = hp.kernel_size
            raw = self.cdna_head(bottleneck.mean(dim=(1, 2)))
            # row-major [kh, kw, N] reshape, as flax's
            kernels = normalize_kernels(raw.reshape(b, kh, kw, hp.num_transformed_images), hp.kernel_normalization)
            aux["kernels"] = kernels
            for f in range(hp.last_frames):
                parts.append(apply_cdna_kernels(last_images[-(f + 1)], kernels))  # [B,N,H,W,C]
        if hp.prev_image_background:
            parts.append(image[:, None])
        if hp.first_image_background:
            parts.append(x["first_image"][:, None])
        if self.has_scratch:
            parts.append(torch.sigmoid(self.scratch_head(feat_top))[:, None])
        candidates = torch.cat(parts, dim=1)  # [B,K,H,W,C]

        # ---- compositing ----
        if self.num_masks == 1:
            gen_image_new = candidates[:, 0]
        else:
            if hp.dependent_mask:
                # mask head input: feat_top, then the candidates in list order
                cand_cat = candidates.permute(0, 2, 3, 1, 4).reshape(b, hgt, wid, self.num_masks * c)
                mask_in = torch.cat([feat_top, cand_cat], dim=-1)
            else:
                mask_in = feat_top
            mask_logits = self.mask_head(mask_in)
            gen_image_new, masks = composite(candidates, mask_logits, with_masks=output_aux)
            if output_aux:
                aux["masks"] = masks

        out = {"gen_image": gen_image_new, **aux}
        return (new_states, gen_image_new, last_images), out


class SAVPGenerator(nn.Module):
    """Full-rollout generator: runs ``SAVPCell`` over time.

    ``forward(images [B,T,H,W,C], use_gt [T-1,B], zs [B,T-1,nz]?, actions?)
    -> {gen_images [B,T-1,H,W,C], masks?, kernels?}``. Predictions are for
    frames 1..T-1 (``gen_images`` aligns with ``images[:, 1:]``).

    ``image_shape`` (H, W, C) and ``action_dim`` fix the parameter shapes,
    as the first batch does for flax's lazy init.
    """

    def __init__(self, hparams: ModelHparams, image_shape: Sequence[int] = (64, 64, 3), action_dim: int = 0):
        super().__init__()
        self.hparams = hparams
        self.image_shape = tuple(image_shape)
        hgt, wid, c = self.image_shape
        self.cell = SAVPCell(hparams, generator_num_scales(hgt, wid), c, action_dim)

    def forward(
        self,
        images: torch.Tensor,
        use_gt: torch.Tensor,
        zs: Optional[torch.Tensor] = None,
        actions: Optional[torch.Tensor] = None,
        output_aux: bool = False,
    ) -> Dict[str, torch.Tensor]:
        hp = self.hparams
        b, t, hgt, wid, c = images.shape
        if (hgt, wid, c) != self.image_shape:
            raise ValueError(f"generator built for {self.image_shape} images, got {tuple(images.shape)}")
        if (actions is None) != (self.cell.action_dim == 0):
            raise ValueError(f"generator built for action_dim={self.cell.action_dim}, "
                             f"got actions {None if actions is None else tuple(actions.shape)}")
        first_image = images[:, 0]
        state = (
            self.cell.init_rnn_states(b, hgt, wid, images.device),
            first_image,
            [first_image] * hp.last_frames,
        )
        outs = []
        for step in range(t - 1):
            x = {"image": images[:, step], "use_gt": use_gt[step], "first_image": first_image}
            if zs is not None and hp.nz > 0:
                x["z"] = zs[:, step]
            if actions is not None:
                x["action"] = actions[:, step]
            state, out = self.cell(state, x, output_aux=output_aux)
            outs.append(out)
        result = {"gen_images": torch.stack([o["gen_image"] for o in outs], dim=1)}
        if output_aux:
            for k in ("masks", "kernels"):
                if k in outs[0]:
                    result[k] = torch.stack([o[k] for o in outs], dim=1)
        return result

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
conditioning, LSTM cells with or without LayerNorm, fp32 or bf16 compute
(``compute_dtype``) and gate maths (``gate_dtype``). The other
transformations, ``learn_prior``, ``use_states``, ``learn_initial_state``,
``context_images_background`` and GRU cells raise ``NotImplementedError``
(ROADMAP.md, queue 1). ``remat``, ``remat_policy``, ``remat_prevent_cse``
and ``scan_unroll`` steer how JAX lowers its scan and mean nothing to a
Python loop, save one choice that follows the JAX condition
(``savp.py:364-366``): with ``scan_unroll == 0`` (and not ``remat`` with
``remat_prevent_cse``) the dependent mask head runs as two convs over the
slices of its kernel plus an add (``_SplitInputConv2D``), else as one conv
over the concat. The two forms have the same parameters and agree within
fp32; in bf16 they round differently. The JAX package's two compositing
forms (fused sum and einsum, ``savp.py:381-390``) are the same fp32 maths;
both are K3 here.

Dtypes (``video_prediction_tpu/models/savp.py``): with ``compute_dtype``
bfloat16 the convs, the norms (their statistics in fp32), the ConvLSTM
states and the CDNA head run in bf16; the images stay fp32. The CDNA
kernels are normalized in fp32, so K1 takes fp32 images and kernels
(``:285-288``); the scratch image's sigmoid runs in bf16 and is cast to the
image dtype (``:345-346``); the mask head reads the candidates cast to the
compute dtype (``:369``, ``:376``); its logits are cast to fp32, exactly,
for K3, whose softmax and sum are fp32 (``:381-391``).

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
    Dense,
    Dtype,
    add_bias,
    cast,
    conv2d_nhwc,
    get_activation,
    get_downsample_layer,
    get_norm_layer,
    get_upsample_layer,
    split_bias,
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
    }
    for name, bad in unsupported.items():
        if bad:
            raise NotImplementedError(f"{name}={getattr(hp, name)!r} {_NOT_PORTED}")


def split_input_conv(conv: Conv2D, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv`` of ``concat([a, b], -1)`` as two convs over the slices of its
    weight and one add, in ``conv.dtype`` (or ``a``'s dtype), then the bias
    (the JAX package's ``_SplitInputConv2D``, ``savp.py:47-97``)."""
    dt = conv.dtype or a.dtype
    w = cast(conv.weight, dt)
    c1 = a.shape[-1]
    fused, after = split_bias(conv.bias, dt)
    return add_bias(conv2d_nhwc(cast(a, dt), w[:, :c1], fused) + conv2d_nhwc(cast(b, dt), w[:, c1:]), after)


class SAVPCell(nn.Module):
    """One generator timestep (reference ``savp_model.py#SAVPCell.call``).

    state = (rnn_states, gen_image, last_images)
    x     = {image, use_gt, first_image, z?, action?}
    out   = {gen_image, masks?, kernels?}
    """

    def __init__(self, hparams: ModelHparams, num_scales: int, image_channels: int, action_dim: int = 0,
                 dtype: Dtype = None):
        super().__init__()
        check_supported(hparams)
        hp = self.hparams = hparams
        self.num_scales = num_scales
        self.dtype = dtype
        gate_dtype = torch.bfloat16 if hp.gate_dtype == "bfloat16" else torch.float32
        ngf, c = hp.ngf, image_channels
        self.action_dim = action_dim
        z_dim = hp.nz if hp.nz > 0 else 0
        z_all = z_dim if hp.where_add == "all" else 0
        norm = get_norm_layer(hp.norm_layer)
        down = get_downsample_layer(hp.downsample_layer)
        up = get_upsample_layer(hp.upsample_layer)
        self.act = get_activation(hp.activation_layer)

        def rnn(in_features: int, features: int) -> ConvLSTMCell:
            return ConvLSTMCell(in_features, features, use_norm=hp.conv_rnn_norm, gate_conv=hp.lstm_gate_conv,
                                dtype=dtype, gate_dtype=gate_dtype)

        # channel order of every concat follows savp.py: input = image, cond,
        # z (:228-232); encoder level = h, z, cond (:251-254); decoder = up(h),
        # skip, z (:268-270)
        stem_in = c + action_dim + (z_dim if hp.where_add in ("input", "all") else 0)
        self.stem = Conv2D(stem_in, ngf, 3, dtype=dtype)
        self.stem_norm = norm(ngf, dtype)
        for s in range(1, num_scales + 1):
            feats = ngf * 2**s
            self.add_module(f"down{s}", down(feats // 2, feats, dtype))
            self.add_module(f"down{s}_norm", norm(feats, dtype))
            cond_all = action_dim if hp.where_add == "all" else 0
            self.add_module(f"enc_rnn{s}", rnn(feats + z_all + cond_all, feats))
        for s in range(num_scales - 1, -1, -1):
            feats = ngf * 2**s
            self.add_module(f"up{s}", up(2 * feats, feats, dtype))
            self.add_module(f"up{s}_norm", norm(feats, dtype))
            z_dec = z_dim if hp.where_add in ("all", "middle") else 0
            self.add_module(f"dec_rnn{s}", rnn(2 * feats + z_dec, feats))

        kh, kw = hp.kernel_size
        n_trans = hp.num_transformed_images
        num_masks = 0
        if n_trans > 0:
            # GAP over the bottleneck, then Dense(kh*kw*N) (savp.py:283-289)
            self.cdna_head = Dense(ngf * 2**num_scales, kh * kw * n_trans, dtype=dtype)
            num_masks += n_trans * hp.last_frames
        num_masks += int(hp.prev_image_background) + int(hp.first_image_background)
        self.has_scratch = hp.generate_scratch_image or num_masks == 0
        if self.has_scratch:
            self.scratch_head = Conv2D(ngf, c, 3, dtype=dtype)
            num_masks += 1
        self.num_masks = num_masks
        if num_masks > 1:
            mask_in = ngf + num_masks * c if hp.dependent_mask else ngf
            self.mask_head = Conv2D(mask_in, num_masks, 3, dtype=dtype)
        # the JAX package's ``fused_composite`` (savp.py:364-366)
        self.split_mask_input = hp.dependent_mask and hp.scan_unroll == 0 and not (hp.remat and hp.remat_prevent_cse)

    def rnn_cells(self) -> List[ConvLSTMCell]:
        """Encoder cells (scales 1..S), then decoder cells (scales S-1..0)."""
        enc = [getattr(self, f"enc_rnn{s}") for s in range(1, self.num_scales + 1)]
        dec = [getattr(self, f"dec_rnn{s}") for s in range(self.num_scales - 1, -1, -1)]
        return enc + dec

    def init_rnn_states(self, batch: int, height: int, width: int, device: torch.device,
                        dtype: torch.dtype = torch.float32) -> list:
        scales = list(range(1, self.num_scales + 1)) + list(range(self.num_scales - 1, -1, -1))
        return [
            cell.initial_state(batch, height // 2**s, width // 2**s, device, dtype)
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
        inputs = cast(image, self.dtype or image.dtype)
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
            # row-major [kh, kw, N] reshape, as flax's; normalized in fp32
            kernels = normalize_kernels(cast(raw.reshape(b, kh, kw, hp.num_transformed_images), torch.float32),
                                        hp.kernel_normalization)
            aux["kernels"] = kernels
            for f in range(hp.last_frames):
                parts.append(apply_cdna_kernels(last_images[-(f + 1)], kernels))  # [B,N,H,W,C]
        if hp.prev_image_background:
            parts.append(image[:, None])
        if hp.first_image_background:
            parts.append(x["first_image"][:, None])
        if self.has_scratch:
            parts.append(cast(torch.sigmoid(self.scratch_head(feat_top)), image.dtype)[:, None])
        candidates = torch.cat(parts, dim=1)  # [B,K,H,W,C]

        # ---- compositing ----
        if self.num_masks == 1:
            gen_image_new = candidates[:, 0]
        else:
            if hp.dependent_mask:
                # mask head input: feat_top, then the candidates in list order
                cand_cat = candidates.permute(0, 2, 3, 1, 4).reshape(b, hgt, wid, self.num_masks * c)
                cand_cat = cast(cand_cat, feat_top.dtype)
                if self.split_mask_input:
                    mask_logits = split_input_conv(self.mask_head, feat_top, cand_cat)
                else:
                    mask_logits = self.mask_head(torch.cat([feat_top, cand_cat], dim=-1))
            else:
                mask_logits = self.mask_head(feat_top)
            # softmax and sum in fp32 (the logits' cast is exact), the image dtype out
            gen_image_new, masks = composite(cast(candidates, torch.float32), cast(mask_logits, torch.float32),
                                              with_masks=output_aux)
            gen_image_new = cast(gen_image_new, image.dtype)
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
    as the first batch does for flax's lazy init. ``dtype`` is the compute
    dtype (None: that of the images); the states are kept in it.
    """

    def __init__(self, hparams: ModelHparams, image_shape: Sequence[int] = (64, 64, 3), action_dim: int = 0,
                 dtype: Dtype = None):
        super().__init__()
        self.hparams = hparams
        self.image_shape = tuple(image_shape)
        self.dtype = dtype
        hgt, wid, c = self.image_shape
        self.cell = SAVPCell(hparams, generator_num_scales(hgt, wid), c, action_dim, dtype)

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
            self.cell.init_rnn_states(b, hgt, wid, images.device, self.dtype or images.dtype),
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

"""SAVP generator: ConvLSTM (or ConvGRU) encoder-decoder with transformation
kernels and masked compositing.

Port of ``video_prediction_tpu/models/savp.py`` (``SAVPCell``,
``SAVPGenerator``, ``generator_num_scales``; reference ``savp_model.py``,
``dna_model.py``, ``sna_model.py``). The JAX package scans the cell over time
with ``nn.scan``; here the time loop is a Python loop. Per step the cell
calls kernel K2 once per ConvLSTM cell with LayerNorm (``ops/rnn.py``),
kernel K1 once per CDNA frame (``ops/cdna.py``) and kernel K3 once where
more than one candidate is composited (``kernels/composite.py``).

Ported: every option of the JAX generator: the ``cdna``, ``dna``,
``stp``, ``flow`` and ``direct`` transformations (DNA, STP and flow as torch
ops, ``ops/cdna.py`` and ``ops/warp.py``: the JAX package leaves them to
XLA); the ``prev``/``first``/``context``/``scratch`` backgrounds; dependent
and independent masks; ``where_add``; action and low-dim state conditioning
with the linear state head; LSTM cells with or without LayerNorm and GRU
cells; learned initial states; the four up- and downsample layers; the
learned prior (``learn_prior``); fp32 or bf16 compute (``compute_dtype``)
and gate maths (``gate_dtype``).
``scan_unroll`` steers how JAX lowers its scan and means nothing to a
Python loop, save one choice that follows the JAX condition
(``savp.py:364-366``): with ``scan_unroll == 0`` (and not ``remat`` with
``remat_prevent_cse``) the dependent mask head runs as two convs over the
slices of its kernel plus an add (``_SplitInputConv2D``), else as one conv
over the concat. The two forms have the same parameters and agree within
fp32; in bf16 they round differently. The JAX package's two compositing
forms (fused sum and einsum, ``savp.py:381-390``) are the same fp32 maths;
both are K3 here.

Recompute (``remat``, ``remat_policy``, ``remat_prevent_cse``; JAX
``savp.py:492-507``, which wraps the scanned cell in ``nn.remat``): a
rollout under grad recomputes the cell in the backward pass where
``recomputes(hp)`` holds, ``remat and (scan_unroll != 0 or
remat_prevent_cse)``; at ``scan_unroll == 0`` without the CSE barrier XLA
merges the JAX recompute back into the forward, so the port keeps
everything there too. ``generate``, ``evaluate`` and the eval step run
without grad and recompute nothing. The maths is the same either way; only
what is kept between the passes changes (``torch.utils.checkpoint``,
non-reentrant, no RNG state: the cell draws no random numbers).

- ``full``: one checkpoint around the cell a timestep. It keeps the cell's
  inputs and carry; the backward reruns the whole cell, in forward order,
  once a timestep.
- ``names``: the JAX save set, ``save_only_these_names("savp_saveable")``.
  Each stretch of ``SAVPCell.stretches`` between two marked tensors is a
  checkpoint of its own, which keeps only its inputs: the cell's inputs
  and carry and the five marked sites, ``act(stem_norm(stem(.)))``
  (``:243``), each ``act(down{s}_norm(down{s}(.)))`` (``:250``), each
  encoder ConvRNN output ``h`` (``:256``), each ``act(up{s}_norm(up{s}(.)))``
  (``:267``) and each decoder ConvRNN output ``h`` (``:272``). Not kept: the
  conv outputs in front of a norm, the gate convs' outputs and K2's inputs
  inside a ConvRNN, the concatenations with the skips, z and the
  conditioning, and everything after ``feat_top`` (the heads, K1, K3). The
  backward reruns every stretch once a timestep, each on its own, from the
  heads back to the stem: every submodule of the cell reruns, as under
  ``full`` (no submodule lies outside the stretches); what ``names``
  changes is what is kept, more than ``full`` and less than no recompute,
  and how much of one timestep is rebuilt at a time (one stretch).

Both rerun K1-K3 forward in the backward, so a recomputing train step
launches each twice a rollout forward and once backward. On a spatial
shard the recompute reruns in the forward's ``spatial_context``
(``_checkpoint``), with its halo exchanges and gathers, in the same order on
every rank.

The low-dim state (``use_states``, JAX ``savp.py:195-232``, :394-401,
:457, :475-479): the carry holds the rolled-out state, started from
``states[:, 0]``; each step takes the ground-truth state where the
scheduled-sampling mask takes the ground-truth image, conditions the cell on
``[action, state]`` (tiled after the image, and at every encoder level under
``where_add == "all"``), and, where actions are given, advances the state by
``state_head``, a fp32 dense layer on ``[state, action]``, whose outputs are
``gen_states``.

The learned prior (``learn_prior``, JAX ``savp.py:205-219``, :480-490):
``LearnedPrior`` (``cell.prior``, ``models/networks.py``) runs in every
step on the frame the cell consumes, the ground truth or the cell's own
last prediction, never a later ground-truth frame; ``z_prior = mu +
exp(logvar / 2) * prior_eps``, the reparameterization noise ``prior_eps
[B,T-1,nz]`` given (zeros when None). Without ``zs`` the cell takes
``z_prior``; with ``zs`` it takes ``z_prior`` for the samples where
``use_prior_z [B]`` is set and ``zs`` elsewhere (``zs`` everywhere when
None). The rollout returns ``prior_mu``, ``prior_logvar`` and the z the
cell took, ``z_used``, each ``[B,T-1,nz]``.

Dtypes (``video_prediction_tpu/models/savp.py``): with ``compute_dtype``
bfloat16 the convs, the norms (their statistics in fp32), the recurrent
states and the CDNA, DNA, STP and flow heads run in bf16; the images, the
low-dim state and its head stay fp32. The transformation kernels, affine
parameters and flows are cast to fp32 before they are applied, so K1 takes
fp32 images and kernels (``:285-288``); the scratch image's sigmoid runs in
bf16 and is cast to the image dtype (``:345-346``); the mask head reads the
candidates cast to the compute dtype (``:369``, ``:376``); its logits are
cast to fp32, exactly, for K3, whose softmax and sum are fp32
(``:381-391``).

Spatial partitioning (``parallel/mesh.py#spatial_context``): the images,
the recurrent states and every activation hold this rank's rows of the
height; the layers take their halos and statistics across the shards
(``ops/layers.py``, ``ops/cdna.py``, ``ops/warp.py``); the global average
pool in front of the CDNA and STP heads is all-reduced
(``parallel/spatial.py#mean_hw``), so the kernels and affine parameters are
whole on every rank; the learned prior runs on the gathered frame; the
learned initial states are cut to this rank's rows; K2 and K3 run per pixel
on the shard's rows.

Module names follow the flax parameter tree (``stem``, ``down1``,
``enc_rnn1``, ..., ``mask_head``, ``state_head``, ``init_state_0``) so that
``convert.py`` maps it directly.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from video_prediction_torch.configs.hparams import ModelHparams
from video_prediction_torch.kernels.composite import composite
from video_prediction_torch.models.networks import LearnedPrior
from video_prediction_torch.ops.cdna import apply_cdna_kernels, apply_dna_kernels, normalize_kernels
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
from video_prediction_torch.ops.rnn import ConvGRUCell, ConvLSTMCell
from video_prediction_torch.ops.warp import apply_affine_kernels, image_warp
from video_prediction_torch.parallel import spatial as SP
from video_prediction_torch.parallel.mesh import current_spatial, spatial_context, whole
from video_prediction_torch.utils import trace

REMAT_POLICIES = ("full", "names")


def _static_log2(n: int) -> int:
    k = 0
    while (1 << (k + 1)) <= n:
        k += 1
    return k


def generator_num_scales(height: int, width: int) -> int:
    """Encoder/decoder scale count for an input resolution: bottleneck at
    8x8 — 3 scales for 64 px, 4 for 128 px, at least 1."""
    return max(1, min(4, _static_log2(min(height, width)) - 3))


def recomputes(hp: ModelHparams) -> bool:
    """Whether a rollout under grad recomputes the generator cell in the
    backward pass: ``remat`` and (``scan_unroll != 0`` or
    ``remat_prevent_cse``), the JAX package's effective rule (its
    ``hparams.py:134-141``, ``savp.py:502-505``: at ``scan_unroll == 0``
    without the CSE barrier XLA merges the recompute back into the forward).
    A rollout without grad recomputes nothing."""
    return bool(hp.remat and (hp.scan_unroll != 0 or hp.remat_prevent_cse))


def _call(fn: Callable, *args):
    return fn(*args)


def _checkpoint(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` under ``torch.utils.checkpoint``: what it saves
    for the backward is dropped and recomputed there. The recompute runs in
    the spatial context of this call: the backward runs after the train step
    has left its context, and on CUDA on autograd's own thread, where the
    context variable reads None. No RNG state is kept: the cell draws no
    random numbers (its noise comes in through ``x``)."""
    mesh = current_spatial()

    def run(*a, **kw):
        with spatial_context(mesh):
            return fn(*a, **kw)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


def split_input_conv(conv: Conv2D, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv`` of ``concat([a, b], -1)`` as two convs over the slices of its
    weight and one add, in ``conv.dtype`` (or ``a``'s dtype), then the bias
    (the JAX package's ``_SplitInputConv2D``, ``savp.py:47-97``)."""
    dt = conv.dtype or a.dtype
    w = cast(conv.weight, dt)
    c1 = a.shape[-1]
    fused, after = split_bias(conv.bias, dt)
    return add_bias(conv2d_nhwc(cast(a, dt), w[:, :c1], fused) + conv2d_nhwc(cast(b, dt), w[:, c1:]), after)


def _leaves(rnn_states: list) -> List[torch.Tensor]:
    """The recurrent states' tensors in flax's flattened order: ``(c, h)`` of
    each LSTM cell, ``h`` of each GRU cell, encoder first."""
    return [t for st in rnn_states for t in (st if isinstance(st, tuple) else (st,))]


def _unflatten(rnn_states: list, leaves: Sequence[torch.Tensor]) -> list:
    it = iter(leaves)
    return [tuple(next(it) for _ in st) if isinstance(st, tuple) else next(it) for st in rnn_states]


class SAVPCell(nn.Module):
    """One generator timestep (reference ``savp_model.py#SAVPCell.call``).

    state = (rnn_states, gen_image, last_images, current_state or None)
    x     = {image, use_gt, first_image, context_images?, z?, action?, state?,
             prior_eps?, use_prior_z?}
    out   = {gen_image, gen_state?, prior_mu?, prior_logvar?, z_used?, masks?,
             kernels?, flows?}

    ``action_dim`` and ``state_dim`` (0: none) fix the conditioning widths.
    """

    def __init__(self, hparams: ModelHparams, num_scales: int, image_channels: int, action_dim: int = 0,
                 state_dim: int = 0, dtype: Dtype = None):
        super().__init__()
        hp = self.hparams = hparams
        self.num_scales = num_scales
        self.dtype = dtype
        gate_dtype = torch.bfloat16 if hp.gate_dtype == "bfloat16" else torch.float32
        ngf, c = hp.ngf, image_channels
        self.action_dim, self.state_dim = action_dim, state_dim
        cond_dim = action_dim + state_dim
        z_dim = hp.nz if hp.nz > 0 else 0
        z_all = z_dim if hp.where_add == "all" else 0
        norm = get_norm_layer(hp.norm_layer)
        down = get_downsample_layer(hp.downsample_layer)
        up = get_upsample_layer(hp.upsample_layer)
        self.act = get_activation(hp.activation_layer)
        self.learn_prior = bool(hp.learn_prior and hp.nz > 0)
        if self.learn_prior:
            self.prior = LearnedPrior(c, hp.nz, hp.nef // 2 or 16, dtype=dtype)

        def rnn(in_features: int, features: int) -> nn.Module:
            if hp.conv_rnn == "lstm":
                return ConvLSTMCell(in_features, features, use_norm=hp.conv_rnn_norm, gate_conv=hp.lstm_gate_conv,
                                    dtype=dtype, gate_dtype=gate_dtype)
            if hp.conv_rnn == "gru":
                return ConvGRUCell(in_features, features, dtype=dtype)
            raise ValueError(f"unknown conv_rnn {hp.conv_rnn!r}")

        # channel order of every concat follows savp.py: input = image,
        # [action, state], z (:228-232); encoder level = h, z, [action, state]
        # (:251-254); decoder = up(h), skip, z (:268-270)
        stem_in = c + cond_dim + (z_dim if hp.where_add in ("input", "all") else 0)
        self.stem = Conv2D(stem_in, ngf, 3, dtype=dtype)
        self.stem_norm = norm(ngf, dtype)
        for s in range(1, num_scales + 1):
            feats = ngf * 2**s
            self.add_module(f"down{s}", down(feats // 2, feats, dtype=dtype))
            self.add_module(f"down{s}_norm", norm(feats, dtype))
            cond_all = cond_dim if hp.where_add == "all" else 0
            self.add_module(f"enc_rnn{s}", rnn(feats + z_all + cond_all, feats))
        for s in range(num_scales - 1, -1, -1):
            feats = ngf * 2**s
            self.add_module(f"up{s}", up(2 * feats, feats, dtype=dtype))
            self.add_module(f"up{s}_norm", norm(feats, dtype))
            z_dec = z_dim if hp.where_add in ("all", "middle") else 0
            self.add_module(f"dec_rnn{s}", rnn(2 * feats + z_dec, feats))

        # the candidates, in savp.py's order (:277-346): the transformed
        # images, prev, first (or the context frames), scratch
        kh, kw = hp.kernel_size
        n_trans = hp.num_transformed_images
        bottleneck = ngf * 2**num_scales
        num_masks = 0
        if hp.transformation == "cdna":
            if n_trans > 0:
                # GAP over the bottleneck, then Dense(kh*kw*N) (savp.py:283-289)
                self.cdna_head = Dense(bottleneck, kh * kw * n_trans, dtype=dtype)
                num_masks += n_trans * hp.last_frames
        elif hp.transformation == "dna":
            # per-pixel kernels from the top features, N = 1 (:295-302)
            self.dna_head = Conv2D(ngf, kh * kw, 3, dtype=dtype)
            num_masks += 1
        elif hp.transformation == "stp":
            if n_trans > 0:
                # GAP, Dense(100), the activation, Dense(6N) zero-initialized
                # (each transform starts at the identity warp; :303-322)
                self.stp_fc = Dense(bottleneck, 100, dtype=dtype)
                self.stp_head = Dense(100, 6 * n_trans, dtype=dtype, zero_init=True)
                num_masks += n_trans * hp.last_frames
        elif hp.transformation == "flow":
            # N flows of the current image from the top features (:323-328)
            self.flow_head = Conv2D(ngf, 2 * n_trans, 3, dtype=dtype)
            num_masks += n_trans
        elif hp.transformation != "direct":
            raise ValueError(f"unknown transformation {hp.transformation!r}")
        num_masks += int(hp.prev_image_background)
        # the context frames subsume the first image (:336-343)
        if hp.context_images_background:
            num_masks += hp.context_frames
        elif hp.first_image_background:
            num_masks += 1
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
        if action_dim and state_dim:
            # the linear state predictor on [state, action], fp32 (no dtype; :394-401)
            self.state_head = Dense(state_dim + action_dim, state_dim)

    def rnn_cells(self) -> List[nn.Module]:
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

    def stretches(self) -> List[List[str]]:
        """The cell's stretches between the tensors ``remat_policy="names"``
        keeps, in forward order, each as the submodules it calls: the stem
        (with the learned prior), each downsampling and each encoder ConvRNN,
        each upsampling and each decoder ConvRNN, then the heads."""
        names = set(dict(self.named_children()))
        out = [[n for n in ("prior", "stem", "stem_norm") if n in names]]
        for s in range(1, self.num_scales + 1):
            out += [[f"down{s}", f"down{s}_norm"], [f"enc_rnn{s}"]]
        for s in range(self.num_scales - 1, -1, -1):
            out += [[f"up{s}", f"up{s}_norm"], [f"dec_rnn{s}"]]
        heads = ("cdna_head", "dna_head", "stp_fc", "stp_head", "flow_head", "scratch_head", "mask_head", "state_head")
        return out + [[n for n in heads if n in names]]

    def forward(self, state: tuple, x: Dict[str, torch.Tensor], output_aux: bool = False,
                segment: Optional[Callable] = None):
        """One timestep. ``segment`` (``remat_policy="names"``) runs each
        stretch of ``stretches`` as ``segment(fn, *args)``; None calls it."""
        run = segment or _call
        rnn_states, gen_image, last_images, current_state = state
        image, current_state, z, cond, h, aux = run(self._stem, gen_image, current_state, x)
        last_images = last_images[1:] + [image]  # the last `last_frames` inputs
        cells = self.rnn_cells()

        # ---- encoder ----
        new_states = []
        skips = [h]
        for s in range(1, self.num_scales + 1):
            h = run(self._down, s, h)
            i = len(new_states)
            st, h = run(self._enc_rnn, cells[i], rnn_states[i], h, z, cond)
            new_states.append(st)
            skips.append(h)
        bottleneck = h

        # ---- decoder ----
        for s in range(self.num_scales - 1, -1, -1):
            h = run(self._up, s, h)
            i = len(new_states)
            st, h = run(self._dec_rnn, cells[i], rnn_states[i], h, skips[s], z)
            new_states.append(st)
        gen_image_new, current_state, heads = run(self._heads, h, bottleneck, image, last_images, current_state, x,
                                                  output_aux)
        out = {"gen_image": gen_image_new, **aux, **heads}
        return (new_states, gen_image_new, last_images, current_state), out

    def _stem(self, gen_image: torch.Tensor, current_state: Optional[torch.Tensor], x: Dict[str, torch.Tensor]):
        """The frame the cell consumes, the state, z and the conditioning
        vector, the stem's output and the learned prior's statistics."""
        hp = self.hparams
        use_gt = x["use_gt"]  # [B] bool
        image = torch.where(use_gt[:, None, None, None], x["image"], gen_image)
        aux: Dict[str, torch.Tensor] = {}
        if current_state is not None and x.get("state") is not None:
            # the ground-truth state where the ground-truth image is taken (:195-202)
            current_state = torch.where(use_gt[:, None], cast(x["state"], current_state.dtype), current_state)
        z = x.get("z")
        if self.learn_prior:
            # p(z_t | the frame the cell consumes) (:205-219), on the whole frame
            full = SP.gathered(image)
            with whole():
                mu_p, logvar_p = self.prior(full)
            aux["prior_mu"], aux["prior_logvar"] = mu_p, logvar_p
            z_prior = mu_p + torch.exp(0.5 * logvar_p) * x["prior_eps"]
            z = z_prior if z is None else torch.where(x["use_prior_z"][:, None], z_prior, z)
            aux["z_used"] = z
        cond_vecs = [v for v in (x.get("action"), current_state) if v is not None]
        cond = torch.cat(cond_vecs, dim=-1) if cond_vecs else None
        inputs = cast(image, self.dtype or image.dtype)
        if cond is not None:
            inputs = tile_concat(inputs, cond)
        if z is not None and hp.where_add in ("input", "all"):
            inputs = tile_concat(inputs, z)
        return image, current_state, z, cond, self.act(self.stem_norm(self.stem(inputs))), aux

    def _down(self, s: int, h: torch.Tensor) -> torch.Tensor:
        return self.act(getattr(self, f"down{s}_norm")(getattr(self, f"down{s}")(h)))

    def _up(self, s: int, h: torch.Tensor) -> torch.Tensor:
        return self.act(getattr(self, f"up{s}_norm")(getattr(self, f"up{s}")(h)))

    def _enc_rnn(self, cell: nn.Module, st, h: torch.Tensor, z: Optional[torch.Tensor], cond: Optional[torch.Tensor]):
        if z is not None and self.hparams.where_add == "all":
            h = tile_concat(h, z)
        if cond is not None and self.hparams.where_add == "all":
            h = tile_concat(h, cond)
        return cell(st, h)

    def _dec_rnn(self, cell: nn.Module, st, h: torch.Tensor, skip: torch.Tensor, z: Optional[torch.Tensor]):
        h = torch.cat([h, skip], dim=-1)
        if z is not None and self.hparams.where_add in ("all", "middle"):
            h = tile_concat(h, z)
        return cell(st, h)

    def _heads(self, feat_top: torch.Tensor, bottleneck: torch.Tensor, image: torch.Tensor,
               last_images: List[torch.Tensor], current_state: Optional[torch.Tensor], x: Dict[str, torch.Tensor],
               output_aux: bool):
        """The candidates, the masks and their composite (K1, K3), and the next
        low-dim state: ``(gen_image, current_state, {gen_state?, kernels?,
        flows?, masks?})``."""
        hp = self.hparams
        b, hgt, wid, c = image.shape
        aux: Dict[str, torch.Tensor] = {}

        # ---- candidates [B,K,H,W,C], in savp.py's order ----
        kh, kw = hp.kernel_size
        n_trans = hp.num_transformed_images
        parts = []
        if hp.transformation == "cdna" and n_trans > 0:
            raw = self.cdna_head(SP.mean_hw(bottleneck))
            # row-major [kh, kw, N] reshape, as flax's; normalized in fp32
            kernels = normalize_kernels(cast(raw.reshape(b, kh, kw, n_trans), torch.float32), hp.kernel_normalization)
            aux["kernels"] = kernels
            for f in range(hp.last_frames):
                parts.append(apply_cdna_kernels(last_images[-(f + 1)], kernels))  # [B,N,H,W,C]
        elif hp.transformation == "dna":
            raw = cast(self.dna_head(feat_top), torch.float32).reshape(b, hgt, wid, kh, kw, 1)
            parts.append(apply_dna_kernels(image, normalize_kernels(raw, hp.kernel_normalization)))  # [B,1,H,W,C]
        elif hp.transformation == "stp" and n_trans > 0:
            hfc = self.act(self.stp_fc(SP.mean_hw(bottleneck)))
            affine = cast(self.stp_head(hfc), torch.float32).reshape(b, n_trans, 6)
            for f in range(hp.last_frames):
                parts.append(apply_affine_kernels(last_images[-(f + 1)], affine))  # [B,N,H,W,C]
        elif hp.transformation == "flow":
            flows = cast(self.flow_head(feat_top), torch.float32).reshape(b, hgt, wid, 2, n_trans)
            aux["flows"] = flows
            parts.extend(image_warp(image, flows[..., i])[:, None] for i in range(n_trans))
        if hp.prev_image_background:
            parts.append(image[:, None])
        if hp.context_images_background:
            parts.append(x["context_images"])  # [B,ctx,H,W,C]
        elif hp.first_image_background:
            parts.append(x["first_image"][:, None])
        if self.has_scratch:
            parts.append(cast(torch.sigmoid(self.scratch_head(feat_top)), image.dtype)[:, None])
        candidates = torch.cat(parts, dim=1)

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

        if current_state is not None and x.get("action") is not None:
            # the next state from the rolled-out [state, action] (:395-401)
            current_state = self.state_head(torch.cat([current_state, x["action"]], dim=-1))
            aux["gen_state"] = current_state
        return gen_image_new, current_state, aux


class SAVPGenerator(nn.Module):
    """Full-rollout generator: runs ``SAVPCell`` over time.

    ``forward(images [B,T,H,W,C], use_gt [T-1,B], zs [B,T-1,nz]?, actions?,
    states?, prior_eps?, use_prior_z?) -> {gen_images [B,T-1,H,W,C],
    gen_states?, prior_mu?, prior_logvar?, z_used?, masks?, kernels?,
    flows?}`` (the prior's inputs and outputs under ``learn_prior``). Predictions are for frames 1..T-1 (``gen_images`` aligns with
    ``images[:, 1:]``); ``states`` is read only under ``use_states``.

    ``image_shape`` (H, W, C), ``action_dim`` and ``state_dim`` fix the
    parameter shapes, as the first batch does for flax's lazy init. ``dtype``
    is the compute dtype (None: that of the images); the recurrent states are
    kept in it. With ``learn_initial_state`` each state tensor starts from a
    parameter ``init_state_{i}`` ``[1,h,w,f]`` (fp32, zero-initialized, in
    ``_leaves`` order) broadcast over the batch (JAX ``savp.py:440-455``).
    Under grad, where ``recomputes(hparams)``, each timestep's cell is
    recomputed in the backward pass by ``remat_policy`` (the module
    docstring); an unknown policy raises when ``remat`` is on. Spans
    (``utils/trace.py``): ``model.rollout``, one a forward, and a
    ``savp.step`` child a timestep (its recompute, in the backward, is in
    none).
    """

    def __init__(self, hparams: ModelHparams, image_shape: Sequence[int] = (64, 64, 3), action_dim: int = 0,
                 state_dim: int = 0, dtype: Dtype = None):
        super().__init__()
        self.hparams = hparams
        self.image_shape = tuple(image_shape)
        self.dtype = dtype
        hgt, wid, c = self.image_shape
        self.cell = SAVPCell(hparams, generator_num_scales(hgt, wid), c, action_dim, state_dim, dtype)
        if hparams.learn_initial_state:
            for i, leaf in enumerate(_leaves(self.cell.init_rnn_states(1, hgt, wid, torch.device("cpu")))):
                self.register_parameter(f"init_state_{i}", nn.Parameter(torch.zeros(leaf.shape)))

    def forward(
        self,
        images: torch.Tensor,
        use_gt: torch.Tensor,
        zs: Optional[torch.Tensor] = None,
        actions: Optional[torch.Tensor] = None,
        states: Optional[torch.Tensor] = None,
        prior_eps: Optional[torch.Tensor] = None,
        use_prior_z: Optional[torch.Tensor] = None,
        output_aux: bool = False,
    ) -> Dict[str, torch.Tensor]:
        hp = self.hparams
        if hp.remat and hp.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {hp.remat_policy!r}")
        recompute = torch.is_grad_enabled() and recomputes(hp)
        b, t, hgt, wid, c = images.shape
        mesh = current_spatial()
        if (SP.global_rows(hgt, mesh), wid, c) != self.image_shape:
            raise ValueError(f"generator built for {self.image_shape} images, got {tuple(images.shape)}"
                             + (f" on a shard of {mesh.k}" if mesh is not None else ""))
        if not hp.use_states:
            states = None
        for name, given, dim in (("action", actions, self.cell.action_dim), ("state", states, self.cell.state_dim)):
            if (given is None) != (dim == 0):
                raise ValueError(f"generator built for {name}_dim={dim}, "
                                 f"got {name}s {None if given is None else tuple(given.shape)}")
        rnn_states = self.cell.init_rnn_states(b, hgt, wid, images.device, self.dtype or images.dtype)
        if hp.learn_initial_state:
            inits = [getattr(self, f"init_state_{i}") for i in range(len(_leaves(rnn_states)))]
            if mesh is not None:
                inits = [SP.take_rows(p, mesh) for p in inits]
            rnn_states = _unflatten(rnn_states, [
                cast(p, leaf.dtype).expand(leaf.shape).contiguous() for p, leaf in zip(inits, _leaves(rnn_states))
            ])
        if self.cell.learn_prior:
            if prior_eps is None:
                prior_eps = torch.zeros(b, t - 1, hp.nz, device=images.device)
            if zs is not None and use_prior_z is None:
                use_prior_z = torch.zeros(b, dtype=torch.bool, device=images.device)  # the given zs win
        with trace.span("model.rollout"):
            first_image = images[:, 0]
            state = (rnn_states, first_image, [first_image] * hp.last_frames, None if states is None else states[:, 0])
            outs = []
            for step in range(t - 1):
                with trace.span("savp.step"):
                    x = {"image": images[:, step], "use_gt": use_gt[step], "first_image": first_image}
                    if hp.context_images_background:
                        x["context_images"] = images[:, : hp.context_frames]
                    if zs is not None and hp.nz > 0:
                        x["z"] = zs[:, step]
                    if actions is not None:
                        x["action"] = actions[:, step]
                    if states is not None:
                        x["state"] = states[:, step]
                    if self.cell.learn_prior:
                        x["prior_eps"] = prior_eps[:, step]
                        if zs is not None:
                            x["use_prior_z"] = use_prior_z
                    if not recompute:
                        state, out = self.cell(state, x, output_aux=output_aux)
                    elif hp.remat_policy == "full":
                        state, out = _checkpoint(self.cell, state, x, output_aux=output_aux)
                    else:
                        state, out = self.cell(state, x, output_aux=output_aux, segment=_checkpoint)
                    outs.append(out)
            result = {"gen_images": torch.stack([o["gen_image"] for o in outs], dim=1)}
            if "gen_state" in outs[0]:
                result["gen_states"] = torch.stack([o["gen_state"] for o in outs], dim=1)
            for k in ("prior_mu", "prior_logvar", "z_used"):
                if k in outs[0]:
                    result[k] = torch.stack([o[k] for o in outs], dim=1)
            if output_aux:
                for k in ("masks", "kernels", "flows"):
                    if k in outs[0]:
                        result[k] = torch.stack([o[k] for o in outs], dim=1)
            return result

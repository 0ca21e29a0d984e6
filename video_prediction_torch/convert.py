"""Carry weights across: a flax params tree -> the port's ``state_dict``.

Takes the JAX package's ``params`` (as from ``init_variables`` or a restored
checkpoint) as nested dicts of numpy arrays — for example
``jax.tree_util.tree_map(np.asarray, params)`` — and, optionally, the
spectral-norm ``u`` vectors as a tree laid out like ``params``, and returns
the ``state_dict`` of ``models.base.VideoPredictionModel``. For the whole
model the ``u`` tree is ``{"discriminator": state["spectral"]}`` (the JAX
package keys ``state["spectral"]`` by discriminator, like
``params["discriminator"]``). Imports no jax.

Mapping:
- the flax tree's module path becomes the torch module path: ``SAVPCell_0``
  is ``cell``; the ``Conv_0`` wrapper level of ``Conv2D`` and the
  ``_SpectralKernel_0`` level of the spectral layers disappear;
  ``Conv2D_0`` inside ``ConvPool2D``/``UpsampleConv2D`` is ``conv``; the
  ``ConvTranspose_0`` level of ``ConvTranspose2D`` disappears too;
- conv kernels HWIO -> OIHW, conv3d kernels THWIO -> OITHW, dense kernels
  ``[in, out]`` -> ``[out, in]``; biases, norm scales and the generator's
  learned initial states (``init_state_{i}``) as they are. A
  ``ConvTranspose`` kernel maps as a conv kernel does: ``ConvTranspose2D``
  flips it and swaps its in/out axes for ``F.conv_transpose2d`` when it
  runs; ``Local2D``'s rank-6 ``kernel`` and ``SeparableLocal2D``'s
  ``vertical``/``horizontal`` keep their names and the JAX layout, which
  the port's layers read as they are;
  ``_SplitInputConv2D``'s single ``[k,k,C1+C2,F]`` kernel under
  ``mask_head/Conv_0`` becomes one ``[F,C1+C2,k,k]`` conv weight;
- the five LayerNorms of a ConvLSTM cell (``ln_i``, ``ln_f``, ``ln_g``,
  ``ln_o``, ``ln_c``) pack into its ``ln`` ``[10, C]``: scale then bias for
  i, f, g, o, c — the rows kernel K2 reads;
- each spectral ``u`` becomes the ``u`` buffer of its layer
  (``discriminator.video.sn_conv3d0.u``), for every discriminator and its
  ``_vae`` twin (``image``, ``video``, ``acvideo``); the learned prior's
  leaves under ``SAVPCell_0/prior`` become ``generator.cell.prior``; the
  frozen VGG16 of ``vgg_cdist_weight`` is outside ``params`` and outside the
  ``state_dict``.

Any subtree converts the same way (one layer's or one discriminator's
params give that module's ``state_dict``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

_RENAME = {"SAVPCell_0": "cell", "Conv2D_0": "conv"}
_DROPPED = ("Conv_0", "ConvTranspose_0", "_SpectralKernel_0")
_LN_GATES = ("ln_i", "ln_f", "ln_g", "ln_o", "ln_c")


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def _key(modules, leaf: str) -> str:
    return ".".join([_RENAME.get(m, m) for m in modules if m not in _DROPPED] + [leaf])


def flax_to_state_dict(params: Mapping[str, Any],
                       spectral: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    ln_rows: Dict[str, Dict[tuple, np.ndarray]] = {}
    for path, arr in _flatten(spectral or {}).items():
        *modules, leaf = path
        if leaf != "u":
            raise ValueError(f"unexpected spectral state {'/'.join(path)}")
        out[_key(modules, leaf)] = torch.tensor(arr)
    for path, arr in _flatten(params).items():
        *modules, leaf = path
        if modules and modules[-1] in _LN_GATES:
            ln_rows.setdefault(_key(modules[:-1], "ln"), {})[(modules[-1], leaf)] = arr
            continue
        if leaf == "kernel" and arr.ndim == 6:
            pass  # Local2D's [H,W,kh,kw,Cin,Cout]: the port keeps the JAX layout and the name
        elif leaf == "kernel":
            if arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)  # THWIO -> OITHW
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif arr.ndim == 2:
                arr = arr.T  # [in, out] -> [out, in]
            else:
                raise ValueError(f"{'/'.join(path)}: unexpected kernel rank {arr.ndim}")
            leaf = "weight"
        elif leaf not in ("bias", "scale", "vertical", "horizontal") and not leaf.startswith("init_state_"):
            raise ValueError(f"unexpected parameter {'/'.join(path)}")
        out[_key(modules, leaf)] = torch.tensor(arr)
    for key, rows in ln_rows.items():
        packed = np.stack([rows[(g, leaf)] for g in _LN_GATES for leaf in ("scale", "bias")])
        out[key] = torch.tensor(packed)
    return out

"""The train step (one backward pass, then the G and D Adam updates and the
spectral ``u`` update) and the eval step (the prior rollout and its metrics).

Port of ``video_prediction_tpu/train/step.py#make_train_step`` and
``#make_eval_step`` for one device and one step per call. ``compute_losses`` places the detaches so
that one backward of ``g_loss + d_loss`` gives each side its own gradients,
as the reference's joint ``sess.run`` does. With ``compute_dtype`` bfloat16
the parameters, their gradients and Adam's moments stay fp32, and there is
no loss scaling, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from video_prediction_torch.train import schedules
from video_prediction_torch.train.state import TrainState


def make_train_step(model) -> Callable[..., Dict[str, torch.Tensor]]:
    """``train_step(ts, batch, noise=None) -> scalars`` for ``model``: updates
    ``ts`` in place and returns the 0-d loss tensors ``g_loss``, ``d_loss``,
    ``g/<term>`` and ``d/<term>`` of the step it took. ``noise`` as
    ``model.draw_noise`` gives it; drawn from ``ts.rng`` when None."""
    hp = model.hparams

    def train_step(ts: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        total, aux = ts.model.compute_losses(batch, ts.step, noise=noise, generator=ts.rng)
        optimizers = [opt for opt in (ts.opt_g, ts.opt_d) if opt is not None]
        for opt in optimizers:
            opt.zero_grad(set_to_none=True)
        total.backward()
        lr = schedules.learning_rate(ts.step, hp)  # optax reads the count before it increments
        for opt in optimizers:
            for group in opt.param_groups:
                group["lr"] = lr
                for p in group["params"]:
                    if p.grad is None:  # optax updates every leaf, with a zero gradient if need be
                        p.grad = torch.zeros_like(p)
            opt.step()
        with torch.no_grad():
            for key, layers in aux["new_state"].get("spectral", {}).items():
                disc = ts.model.discriminator[key]
                for layer, u in layers.items():
                    getattr(disc, layer).u.copy_(u)
        ts.step += 1
        return {
            "g_loss": aux["g_loss"].detach(),
            "d_loss": aux["d_loss"].detach(),
            **{f"g/{k}": v.detach() for k, v in aux["g_losses"].items()},
            **{f"d/{k}": v.detach() for k, v in aux["d_losses"].items()},
        }

    return train_step


def make_eval_step(model) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``eval_step(batch, zs_prior=None, generator=None) -> (gen_images,
    metrics)`` for ``model``: the prior rollout of ``forward(train=False)``
    and ``model.metrics_fn`` of it, under ``torch.inference_mode()``. The
    prior z is ``zs_prior`` when given, else drawn from ``generator`` (a
    ``torch.Generator`` on the batch's device)."""

    def eval_step(batch: Dict[str, torch.Tensor], zs_prior: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        with torch.inference_mode():
            out = model(batch, train=False, zs_prior=zs_prior, generator=generator)
            return out["gen_images"], model.metrics_fn(out, batch)

    return eval_step

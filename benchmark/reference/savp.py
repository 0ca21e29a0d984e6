"""Plain PyTorch reference of the SAVP generator, its posterior, the SN video
discriminators, the VAE-GAN losses and Adam (Lee et al. 2018,
arXiv:1804.01523; the published ``ours_savp`` configurations).

Written against the published description and frozen with the benchmark:
it imports nothing of the program under test. Every function is a function
of a weights dict ``P`` (parameter name -> tensor, the names of the
program's ``state_dict``, which the benchmark fills from its seed and hands
to both sides) and the inputs; the spectral ``u`` vectors are ``U`` (the
``.u`` buffers under the same names). Tensors are NHWC (clips NTHWC), as the
program's are. Only what the benchmark's configurations use is written
here, and ``check_supported`` refuses the rest:

- the generator: a conv stem, ``S`` scales of conv + 2x2 average pool down
  and nearest x2 + conv up, instance norm (eps 1e-6) and ReLU after each,
  a 5x5 ConvLSTM at every scale (separate input and hidden gate convs, a
  LayerNorm on each gate and on the cell, forget bias 1), z tiled onto the
  stem's input and onto every ConvLSTM's input, the decoder taking the
  encoder's skips; the heads: CDNA (a dense layer on the bottleneck's
  spatial mean, ``N`` softmax-normalized ``k x k`` kernels applied to the
  current frame), the previous and the first frame, a sigmoid scratch
  image, and a dependent mask (a conv over the top features and the
  candidates, softmax over the candidates) that composites them;
- the posterior: frame pairs through three 4x4 stride-2 convs (instance
  norm after the last two, leaky ReLU 0.2), the spatial mean, dense mu and
  log-variance heads;
- the video discriminator: six spectrally normalized 3-D convs (leaky ReLU
  0.1, each map a feature) and a spectrally normalized dense layer on the
  NTHWC-flattened last map; one power iteration a step, differentiated
  through, from the stored ``u``;
- the training step: the prior and the posterior rollouts as one doubled
  batch, scheduled sampling (inverse sigmoid), the L1, KL (linear anneal)
  and LSGAN terms of both discriminators, the posterior discriminator's
  feature matching, one gradient of the whole objective, Adam on both
  sides, then the advanced ``u``. The gradient is summed over blocks of at
  most ``BLOCK`` samples, so that a large batch fits: each block's backward
  pass takes its share of the objective (every batch mean over the whole
  batch), and the spectrally normalized weights, computed once a step, are
  differentiated once, on the summed gradient.

Whatever ``compute_dtype`` and ``gate_dtype`` a configuration states, the
reference computes in fp32: a lower precision is the program's choice, not
mathematics the reference is missing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6
SN_EPS = 1e-12
FORGET_BIAS = 1.0
ADAM_EPS = 1e-8
GEN = "generator.cell."
BLOCK = 16  # samples a backward pass of the training step
DISCRIMINATORS = ("video", "video_vae")
DTYPES = ("float32", "bfloat16")  # the compute and gate dtypes a configuration may state
# the video discriminator's layers: (features / ndf, kernel (T, H, W), strides)
VIDEO_DISC = [
    (1, (1, 3, 3), (1, 1, 1)),
    (1, (3, 4, 4), (1, 2, 2)),
    (2, (3, 3, 3), (1, 1, 1)),
    (2, (3, 4, 4), (2, 2, 2)),
    (4, (3, 3, 3), (1, 1, 1)),
    (4, (3, 4, 4), (2, 2, 2)),
]
SUPPORTED = {
    "downsample_layer": "conv_pool2d", "upsample_layer": "upsample_conv2d", "norm_layer": "instance",
    "activation_layer": "relu", "conv_rnn": "lstm", "conv_rnn_norm": True, "learn_initial_state": False,
    "transformation": "cdna", "kernel_normalization": "softmax", "last_frames": 1,
    "prev_image_background": True, "first_image_background": True, "context_images_background": False,
    "generate_scratch_image": True, "dependent_mask": True, "where_add": "all", "use_states": False,
    "learn_prior": False, "latent_time_invariant": False, "lstm_gate_conv": "split", "gan_loss_type": "LSGAN",
    "schedule_sampling": "inverse_sigmoid", "schedule_sampling_exact": False, "kl_anneal": "linear",
}
ZERO_WEIGHTS = ("l2_weight", "vgg_cdist_weight", "state_weight", "tv_weight", "z_l1_weight", "image_sn_gan_weight",
                "image_sn_vae_gan_weight", "acvideo_sn_gan_weight", "acvideo_sn_vae_gan_weight",
                "gan_feature_l2_weight")


def check_supported(hp: Dict) -> None:
    bad = {k: hp[k] for k, v in SUPPORTED.items() if hp[k] != v}
    bad.update({k: hp[k] for k in ZERO_WEIGHTS if hp[k]})
    bad.update({k: hp[k] for k in ("compute_dtype", "gate_dtype") if hp[k] not in DTYPES})
    if bad or hp["nz"] <= 0:
        raise ValueError(f"the reference does not compute these settings: {bad or {'nz': hp['nz']}}")


def num_scales(height: int, width: int) -> int:
    """Bottleneck at 8x8: 3 scales at 64 px."""
    return max(1, min(4, int(math.log2(min(height, width))) - 3))


# ---------------------------------------------------------------- layers --
def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with OIHW ``w``."""
    (pt, pb), (pl, pr) = same_pads(x.shape[1], w.shape[2], stride), same_pads(x.shape[2], w.shape[3], stride)
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)), w, b, stride=stride)
    return y.permute(0, 2, 3, 1)


def conv3d(x: torch.Tensor, w: torch.Tensor, b, strides: Sequence[int]) -> torch.Tensor:
    """SAME 3-D conv of NTHWC ``x`` with OITHW ``w``."""
    pads: List[int] = []
    for size, k, s in reversed(list(zip(x.shape[1:4], w.shape[2:], strides))):
        pads.extend(same_pads(size, k, s))
    y = F.conv3d(F.pad(x.permute(0, 4, 1, 2, 3), pads), w, b, stride=tuple(strides))
    return y.permute(0, 2, 3, 4, 1)


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mu).square().mean(dim=(1, 2), keepdim=True)
    return (x - mu) * torch.rsqrt(var + NORM_EPS) * scale + bias


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + NORM_EPS) * scale + bias


def tile(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v [B, D]`` tiled over ``x``'s H and W and concatenated to it."""
    b, h, w, _ = x.shape
    return torch.cat([x, v[:, None, None, :].to(x.dtype).expand(b, h, w, v.shape[-1])], dim=-1)


def conv_lstm(P: Dict, name: str, state, x: torch.Tensor):
    c, h = state
    z = conv2d(x, P[name + ".gates_x.weight"]) + conv2d(h, P[name + ".gates_h.weight"])
    ln = P[name + ".ln"]
    i, f, g, o = z.split(c.shape[-1], dim=-1)
    i = torch.sigmoid(layer_norm(i, ln[0], ln[1]))
    f = torch.sigmoid(layer_norm(f, ln[2], ln[3]) + FORGET_BIAS)
    g = torch.tanh(layer_norm(g, ln[4], ln[5]))
    o = torch.sigmoid(layer_norm(o, ln[6], ln[7]))
    c_new = f * c + i * g
    h_new = o * torch.tanh(layer_norm(c_new, ln[8], ln[9]))
    return (c_new, h_new), h_new


def cdna(image: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """``image [B,H,W,C]`` x ``kernels [B,k,k,N]`` -> ``[B,N,H,W,C]``: each
    sample's N kernels correlated with its image, zero SAME padding."""
    b, h, w, c = image.shape
    _, kh, kw, n = kernels.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    padded = F.pad(image, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph))
    out = image.new_zeros((b, n, h, w, c))
    for i in range(kh):
        for j in range(kw):
            out = out + padded[:, None, i : i + h, j : j + w, :] * kernels[:, i, j, :, None, None, None]
    return out


# ------------------------------------------------------------- generator --
def _cell(P: Dict, hp: Dict, scales: int, states: list, image, first, z):
    """One generator step: the new recurrent states and the predicted frame."""
    ngf, (kh, kw), n = hp["ngf"], hp["kernel_size"], hp["num_transformed_images"]
    b, hh, ww, c = image.shape

    def norm_act(x, name):
        return F.relu(instance_norm(x, P[GEN + name + ".scale"], P[GEN + name + ".bias"]))

    h = norm_act(conv2d(tile(image, z), P[GEN + "stem.weight"], P[GEN + "stem.bias"]), "stem_norm")
    skips, new = [h], []
    for s in range(1, scales + 1):
        h = F.avg_pool2d(conv2d(h, P[f"{GEN}down{s}.conv.weight"], P[f"{GEN}down{s}.conv.bias"])
                         .permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        h = norm_act(h, f"down{s}_norm")
        st, h = conv_lstm(P, f"{GEN}enc_rnn{s}", states[len(new)], tile(h, z))
        new.append(st)
        skips.append(h)
    bottleneck = h
    for s in range(scales - 1, -1, -1):
        up = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        h = norm_act(conv2d(up, P[f"{GEN}up{s}.conv.weight"], P[f"{GEN}up{s}.conv.bias"]), f"up{s}_norm")
        st, h = conv_lstm(P, f"{GEN}dec_rnn{s}", states[len(new)], tile(torch.cat([h, skips[s]], dim=-1), z))
        new.append(st)
    raw = F.linear(bottleneck.mean(dim=(1, 2)), P[GEN + "cdna_head.weight"], P[GEN + "cdna_head.bias"])
    kernels = torch.softmax(raw.reshape(b, kh * kw, n).float(), dim=1).reshape(b, kh, kw, n)
    scratch = torch.sigmoid(conv2d(h, P[GEN + "scratch_head.weight"], P[GEN + "scratch_head.bias"]))
    candidates = torch.cat([cdna(image.float(), kernels).to(image.dtype), image[:, None], first[:, None],
                            scratch.to(image.dtype)[:, None]], dim=1)  # [B,K,H,W,C]
    k = candidates.shape[1]
    flat = candidates.permute(0, 2, 3, 1, 4).reshape(b, hh, ww, k * c)
    logits = conv2d(torch.cat([h, flat.to(h.dtype)], dim=-1), P[GEN + "mask_head.weight"], P[GEN + "mask_head.bias"])
    masks = torch.softmax(logits.float(), dim=-1)
    gen = torch.einsum("bkhwc,bhwk->bhwc", candidates.float(), masks)
    return new, gen


def rollout(P: Dict, hp: Dict, images: torch.Tensor, use_gt: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """``images [B,T,H,W,C]`` in [0, 1], ``use_gt [T-1,B]``, ``zs [B,T-1,nz]``
    -> the predicted frames ``[B,T-1,H,W,C]`` (aligned with ``images[:, 1:]``)."""
    b, t, hh, ww, c = images.shape
    scales = num_scales(hh, ww)
    shapes = [s for s in range(1, scales + 1)] + [s for s in range(scales - 1, -1, -1)]
    states = []
    for s in shapes:
        zero = images.new_zeros((b, hh >> s, ww >> s, hp["ngf"] << s))
        states.append((zero, zero))
    first = gen = images[:, 0]
    outs = []
    for step in range(t - 1):
        image = torch.where(use_gt[step][:, None, None, None], images[:, step], gen)
        states, gen = _cell(P, hp, scales, states, image, first, zs[:, step])
        gen = gen.to(images.dtype)
        outs.append(gen)
    return torch.stack(outs, dim=1)


def posterior(P: Dict, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q(z_t | x_t, x_t+1): ``(mu, logvar)``, each ``[B,T-1,nz]``."""
    b, t, hh, ww, c = images.shape
    x = torch.cat([images[:, :-1], images[:, 1:]], dim=-1).reshape(b * (t - 1), hh, ww, 2 * c)
    x = F.leaky_relu(conv2d(x, P["posterior.conv0.weight"], P["posterior.conv0.bias"], 2), 0.2)
    for i in (1, 2):
        x = conv2d(x, P[f"posterior.conv{i}.weight"], P[f"posterior.conv{i}.bias"], 2)
        x = F.leaky_relu(instance_norm(x, P[f"posterior.norm{i}.scale"], P[f"posterior.norm{i}.bias"]), 0.2)
    x = x.mean(dim=(1, 2))
    mu = F.linear(x, P["posterior.mu.weight"], P["posterior.mu.bias"])
    logvar = F.linear(x, P["posterior.logvar.weight"], P["posterior.logvar.bias"])
    return mu.float().reshape(b, t - 1, -1), logvar.float().reshape(b, t - 1, -1)


def eval_rollout(P: Dict, hp: Dict, images: torch.Tensor, zs: torch.Tensor) -> torch.Tensor:
    """The prior rollout of evaluation and generation: ground truth for the
    context frames, the model's own frames after, ``zs`` the prior draws."""
    t, b = images.shape[1], images.shape[0]
    use_gt = (torch.arange(t - 1, device=images.device)[:, None] < hp["context_frames"]).expand(t - 1, b)
    return rollout(P, hp, images, use_gt, zs)


# --------------------------------------------------------- discriminator --
def l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(v.square().sum() + SN_EPS)


def spectral_weight(w: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(w / sigma, advanced u)``: one power iteration on the weight with its
    output axis last, in fp32, differentiated through; ``u`` is cut."""
    mat = w.reshape(w.shape[0], -1).t().float()
    v = l2_normalize(mat @ u.detach().float())
    u_new = l2_normalize(mat.t() @ v)
    sigma = torch.einsum("i,ij,j->", v, mat, u_new)
    return w / sigma.to(w.dtype), u_new.detach()


def normalized_weights(P: Dict, U: Dict, name: str) -> Tuple[Dict, Dict]:
    """``(weights, advanced u)`` of discriminator ``name``, each by layer: its
    spectrally normalized weights (``spectral_weight``) from the stored ``u``."""
    pre = f"discriminator.{name}."
    layers = [f"sn_conv3d{i}" for i in range(len(VIDEO_DISC))] + ["sn_fc"]
    pairs = {layer: spectral_weight(P[f"{pre}{layer}.weight"], U[f"{pre}{layer}.u"]) for layer in layers}
    return {k: w for k, (w, _) in pairs.items()}, {k: u for k, (_, u) in pairs.items()}


def apply_discriminator(P: Dict, W: Dict, name: str, clips: torch.Tensor, detach: bool = False):
    """``clips [B,T,H,W,C]`` -> ``(logits [B,1], features)`` of discriminator
    ``name`` with its normalized weights ``W``; ``detach``: its weights and
    biases carry no gradient."""
    pre = f"discriminator.{name}."

    def cut(p):
        return p.detach() if detach else p

    x, feats = clips, []
    for i, (_, _, strides) in enumerate(VIDEO_DISC):
        x = F.leaky_relu(conv3d(x, cut(W[f"sn_conv3d{i}"]), cut(P[f"{pre}sn_conv3d{i}.bias"]), strides), 0.1)
        feats.append(x)
    logits = F.linear(x.reshape(x.shape[0], -1), cut(W["sn_fc"]), cut(P[pre + "sn_fc.bias"]))
    return logits, feats


# ---------------------------------------------------------------- losses --
def ground_truth_prob(step: int, hp: Dict) -> torch.Tensor:
    """Inverse-sigmoid scheduled sampling, in float32 as the step tensor's."""
    k = hp["schedule_sampling_k"]
    rel = max(step - hp["schedule_sampling_steps"][0], 0)
    x = torch.clamp(torch.tensor(float(rel), dtype=torch.float32) / k, max=30.0)
    return k / (k + torch.exp(x))


def kl_anneal(step: int, hp: Dict) -> float:
    s0, s1 = hp["kl_anneal_steps"]
    return min(max((step - s0) / max(s1 - s0, 1), 0.0), 1.0)


def learning_rate(step: int, hp: Dict) -> float:
    s0, s1 = hp["decay_steps"]
    if s1 <= s0:
        return hp["lr"]
    return hp["lr"] + (hp["end_lr"] - hp["lr"]) * min(max((step - s0) / (s1 - s0), 0.0), 1.0)


def block_losses(P: Dict, W: Dict, hp: Dict, images_u8: torch.Tensor, noise: Dict, step: int, batch: int):
    """A block's share of one step's objective: ``(total, g_loss, d_loss, the
    doubled rollout's frames)``, each batch mean taken over the ``batch``
    samples of the whole step. ``W``: each discriminator's normalized
    weights, by name; ``noise``: the block's rows of ``use_gt_u [T-1,B]``,
    ``eps_q`` and ``z_p`` ``[B,T-1,nz]``, and ``clip_start`` (0-d)."""
    images = images_u8.float() / 255.0
    b, t = images.shape[:2]
    share = b / batch
    ctx = hp["context_frames"]
    in_context = torch.arange(t - 1, device=images.device)[:, None] < ctx
    use_gt = in_context | (noise["use_gt_u"] < ground_truth_prob(step, hp).to(images.device))
    mu, logvar = posterior(P, images)
    z_q = mu + torch.exp(0.5 * logvar) * noise["eps_q"]
    gen2 = rollout(P, hp, torch.cat([images, images]), torch.cat([use_gt, use_gt], dim=1),
                   torch.cat([noise["z_p"], z_q]))
    gen, recon = gen2[:b], gen2[b:]
    target = images[:, 1:]
    g = {"l1": hp["l1_weight"] * (recon - target).abs().mean() * share}
    kl = 0.5 * (mu.square() + logvar.exp() - 1.0 - logvar)
    g["kl"] = hp["kl_weight"] * kl_anneal(step, hp) * kl.sum(-1).mean() * share
    d = {}
    clip_len = min(hp["clip_length"], t - 1)
    start = int(noise["clip_start"].clamp(0, t - 1 - clip_len))
    real = target[:, start : start + clip_len]
    for key, fake, weight, feat_weight in (("video", gen, hp["video_sn_gan_weight"], 0.0),
                                           ("video_vae", recon, hp["video_sn_vae_gan_weight"],
                                            hp["vae_gan_feature_l2_weight"])):
        fake = fake[:, start : start + clip_len]
        logits, feats = apply_discriminator(P, W[key], key, torch.cat([real, fake.detach()]))
        lr_, lf_ = logits.float().chunk(2)
        d[key + "_real"] = weight * (lr_ - 1.0).square().mean() * share
        d[key + "_fake"] = weight * lf_.square().mean() * share
        logits_g, feats_g = apply_discriminator(P, W[key], key, fake, detach=True)
        g[key] = weight * (logits_g.float() - 1.0).square().mean() * share
        if feat_weight:
            diffs = [(fr.chunk(2)[0].detach().float() - fg.float()).square().mean() for fr, fg in zip(feats, feats_g)]
            g[key + "_feat"] = feat_weight * torch.stack(diffs).mean() * share
    g_loss, d_loss = sum(g.values()), sum(d.values())
    return g_loss + d_loss, g_loss, d_loss, gen2.detach()


def train_losses(P: Dict, U: Dict, hp: Dict, images_u8: torch.Tensor, noise: Dict, step: int):
    """The objective of one step over the whole batch: ``(total, g_loss,
    d_loss, advanced u by discriminator, the doubled rollout's frames)``."""
    W, new_u = {}, {}
    for key in DISCRIMINATORS:
        W[key], new_u[key] = normalized_weights(P, U, key)
    total, g_loss, d_loss, frames = block_losses(P, W, hp, images_u8, noise, step, images_u8.shape[0])
    return total, g_loss, d_loss, new_u, frames


def noise_rows(noise: Dict, rows: slice) -> Dict:
    """The rows of one step's noise that belong to the samples ``rows``."""
    return {k: v if v.ndim == 0 else v[:, rows] if k == "use_gt_u" else v[rows] for k, v in noise.items()}


def step_gradients(params: Dict, U: Dict, hp: Dict, images_u8: torch.Tensor, noise: Dict, step: int,
                   block: int = BLOCK):
    """One step's gradient of the whole batch's objective, into each
    parameter's ``.grad``, summed over blocks of ``block`` samples: ``(g_loss,
    d_loss, advanced u by discriminator, the doubled rollout's frames)``. The
    power iteration runs once, on the whole step's weights; each block's
    backward pass stops at the normalized weights, and their summed gradient
    goes through the power iteration once. A batch of one block takes the
    whole batch's objective (``train_losses``) and one backward pass."""
    batch = images_u8.shape[0]
    if batch <= block:
        total, g_loss, d_loss, new_u, frames = train_losses(params, U, hp, images_u8, noise, step)
        total.backward()
        return float(g_loss.detach()), float(d_loss.detach()), new_u, frames
    W, new_u = {}, {}
    for key in DISCRIMINATORS:
        W[key], new_u[key] = normalized_weights(params, U, key)
    leaves = {key: {k: w.detach().requires_grad_(True) for k, w in ws.items()} for key, ws in W.items()}
    g_loss = d_loss = 0.0
    prior, post = [], []
    for lo in range(0, batch, block):
        rows = slice(lo, min(lo + block, batch))
        total, g, d, frames = block_losses(params, leaves, hp, images_u8[rows], noise_rows(noise, rows), step, batch)
        total.backward()
        g_loss, d_loss = g_loss + float(g.detach()), d_loss + float(d.detach())
        n = rows.stop - rows.start
        prior.append(frames[:n])
        post.append(frames[n:])
        del total, g, d, frames
    normalized = [w for key in W for w in W[key].values()]
    torch.autograd.backward(normalized, [leaves[key][k].grad for key in W for k in W[key]])
    return g_loss, d_loss, new_u, torch.cat(prior + post)


def train_steps(P0: Dict, U0: Dict, hp: Dict, batches: List[torch.Tensor], noises: List[Dict],
                first_step: int = 0, block: int = BLOCK) -> Dict:
    """``len(batches)`` training steps from the weights ``P0`` and the ``u``
    vectors ``U0``, each step's gradient summed over blocks of ``block``
    samples (``step_gradients``): each step's ``g_loss`` and ``d_loss``,
    each leaf's first gradient norm (``grad_norms``), the share of its first
    gradient's elements under ten times Adam's epsilon (``tiny_grad_share``),
    where Adam's update is no longer near its sign, and the norm of each
    leaf's change over the steps (``change_norms``), by name, the first
    step's doubled rollout (``first_frames``, the prior's then the
    posterior's) and the ``u`` vectors after each step (``u_by_step``)."""
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in P0.items()}
    U = {k: v.detach().clone().float() for k, v in U0.items()}
    state = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in params.items()}
    b1, b2 = hp["beta1"], hp["beta2"]
    losses, grad_norms, u_by_step = [], None, []
    for i, (images, noise) in enumerate(zip(batches, noises)):
        step = first_step + i
        for p in params.values():
            p.grad = None
        g_loss, d_loss, new_u, frames = step_gradients(params, U, hp, images, noise, step, block)
        losses.append((g_loss, d_loss))
        with torch.no_grad():
            if grad_norms is None:
                first_frames = frames.float()
                grad_norms = {k: float(p.grad.norm()) if p.grad is not None else 0.0 for k, p in params.items()}
                tiny_grad_share = {k: float((p.grad.abs() < 10 * ADAM_EPS).float().mean()) if p.grad is not None
                                   else 1.0 for k, p in params.items()}
            lr, t = learning_rate(step, hp), i + 1
            for k, p in params.items():
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                m, v = state[k]
                m.mul_(b1).add_(grad, alpha=1 - b1)
                v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
                denom = (v.sqrt() / math.sqrt(1 - b2**t)).add_(ADAM_EPS)
                p.addcdiv_(m, denom, value=-lr / (1 - b1**t))
            for key, layers in new_u.items():
                for layer, u in layers.items():
                    U[f"discriminator.{key}.{layer}.u"] = u
        u_by_step.append(dict(U))
        del frames
    with torch.no_grad():
        change_norms = {k: float((p - P0[k].float()).norm()) for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "tiny_grad_share": tiny_grad_share,
            "change_norms": change_norms, "first_frames": first_frames, "u_by_step": u_by_step}

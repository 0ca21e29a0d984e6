"""The perceptual metrics' split for best-of-N evaluation
(``models/vgg.py#VGGMetric``, ``models/lpips.py#LPIPSMetric``,
``evaluate.py#BestOfN``), on the CPU at a tiny size with seeded random VGG16
weights: ``BestOfN``'s reductions through the split against the same metric
as a plain function, the frames the trunk sees, and the training loss's
gradients through ``__call__``. ``tests/test_torch_metrics.py`` holds
``score(prepare(target), pred)`` against the JAX package. No jax here::

    python -m pytest --noconftest tests/test_torch_bestofn.py -q
"""

import pytest
import torch

from video_prediction_torch.evaluate import BestOfN, Negated
from video_prediction_torch.metrics import peak_signal_to_noise_ratio as psnr
from video_prediction_torch.models.lpips import LPIPSMetric
from video_prediction_torch.models.vgg import VGGMetric

torch.set_num_threads(1)

B, K, TP, S = 2, 3, 2, 32  # clips, samples a chunk, scored frames, image size
CTX = 2


def lpips_metric():
    m = LPIPSMetric(allow_random=True)
    g = torch.Generator().manual_seed(5)
    m.lins = [torch.rand(lin.shape, generator=g) for lin in m.lins]  # unequal channel weights
    return m


METRICS = {"vgg": lambda: VGGMetric(allow_random=True), "lpips": lpips_metric}


def images(*lead, seed):
    return torch.rand(*lead, S, S, 3, generator=torch.Generator().manual_seed(seed))


def chunks(seed):
    """Three chunks ``[B, take, T - 1, S, S, 3]`` of 3, 3 and 1 samples (the last partial)."""
    return [images(B, take, TP + CTX - 1, seed=seed + i) for i, take in enumerate((K, K, 1))]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_bestofn_through_the_split_equals_the_plain_function(name):
    metric = METRICS[name]()
    split = Negated(metric) if name == "lpips" else metric
    plain = lambda t, p: split(t, p)  # noqa: E731  (no prepare: BestOfN's per-sample path)
    target = images(B, TP, seed=10)
    reds = [BestOfN({"psnr": psnr, "m": fn}, target, CTX, keep_best=True) for fn in (split, plain)]
    assert reds[0].split == {"m"} and reds[1].split == set()
    with torch.inference_mode():
        for chunk in chunks(seed=20):
            outs = [red.update(chunk) for red in reds]
            torch.testing.assert_close(outs[0]["m"], outs[1]["m"], atol=1e-5, rtol=0)
    fast, slow = reds
    assert fast.n == slow.n == 2 * K + 1
    for m in ("psnr", "m"):
        torch.testing.assert_close(fast.best[m], slow.best[m], atol=1e-5, rtol=0)
        torch.testing.assert_close(fast.sum[m], slow.sum[m], atol=1e-5, rtol=0)
        torch.testing.assert_close(fast.mean()[m], slow.mean()[m], atol=1e-5, rtol=0)
    torch.testing.assert_close(fast.best_gen, slow.best_gen, atol=0, rtol=0)


def test_bestofn_featurises_the_target_once_a_batch():
    """A forward hook on the trunk: the target's B x Tp frames once, in the
    first update, then B x take x Tp predicted frames an update."""
    metric = VGGMetric(allow_random=True)
    seen = []
    hook = metric.module.register_forward_hook(lambda mod, args, out: seen.append(args[0].shape[0]))
    try:
        red = BestOfN({"vgg_csim": metric}, images(B, TP, seed=30), CTX, keep_best=False)
        with torch.inference_mode():
            for chunk in chunks(seed=40):
                red.update(chunk)
    finally:
        hook.remove()
    assert seen == [B * TP, B * K * TP, B * K * TP, B * 1 * TP]
    assert set(red.prepared) == {"vgg_csim"}


def test_call_still_back_propagates():
    """``__call__`` is the ``vgg_cdist`` loss: gradients reach both inputs."""
    metric = VGGMetric(allow_random=True)
    a = images(B, TP, seed=50).requires_grad_(True)
    b = images(B, TP, seed=51).requires_grad_(True)
    loss = (1.0 - metric(a, b)).mean()
    loss.backward()
    for x in (a, b):
        assert x.grad is not None and x.grad.shape == x.shape
        assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0

"""The port's ``ConvLSTMCell`` against flax's, from converted weights: both
gate-conv layouts (split, merged), with and without per-gate LayerNorm. With
norm the port's gate maths is kernel K2 (its plain version on CPU), so this
also checks how the five flax LayerNorms pack into K2's ``[10, C]`` rows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_prediction_torch.convert import flax_to_state_dict
from video_prediction_torch.ops.rnn import ConvLSTMCell
from video_prediction_tpu.ops import rnn as jrnn

torch.set_num_threads(1)

ATOL = 1e-5  # one fp32 conv step plus the gate maths


@pytest.mark.parametrize("use_norm", [True, False])
@pytest.mark.parametrize("gate_conv", ["split", "merged"])
def test_conv_lstm_cell_matches_flax(gate_conv, use_norm):
    rng = np.random.RandomState(0)
    b, h, w, cin, f = 2, 6, 6, 5, 8
    x = rng.randn(b, h, w, cin).astype(np.float32)
    c0 = rng.randn(b, h, w, f).astype(np.float32)
    h0 = rng.randn(b, h, w, f).astype(np.float32)

    cell = jrnn.ConvLSTMCell(f, 5, use_norm=use_norm, gate_conv=gate_conv)
    carry = (jnp.asarray(c0), jnp.asarray(h0))
    params = cell.init(jax.random.PRNGKey(0), carry, jnp.asarray(x))["params"]
    # move every leaf off its init value (LN scales off 1, biases off 0), a
    # different amount per gate, so a mis-packed LN row cannot pass
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.3 * rng.randn(*a.shape).astype(np.float32), params
    )
    (c_ref, h_ref), y_ref = cell.apply({"params": params}, carry, jnp.asarray(x))

    tcell = ConvLSTMCell(cin, f, use_norm=use_norm, gate_conv=gate_conv)
    tcell.load_state_dict(flax_to_state_dict(params))
    with torch.no_grad():
        (c1, h1), y = tcell((torch.from_numpy(c0), torch.from_numpy(h0)), torch.from_numpy(x))
    np.testing.assert_allclose(c1.numpy(), np.asarray(c_ref), atol=ATOL)
    np.testing.assert_allclose(h1.numpy(), np.asarray(h_ref), atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL)


def test_parameter_layout():
    split = ConvLSTMCell(5, 8, use_norm=True, gate_conv="split")
    assert split.gates_x.bias is None and split.gates_h.bias is None
    assert tuple(split.ln.shape) == (10, 8)
    assert ConvLSTMCell(5, 8, use_norm=False, gate_conv="split").gates_x.bias is not None
    merged = ConvLSTMCell(5, 8, use_norm=False, gate_conv="merged")
    assert tuple(merged.gates.weight.shape) == (32, 13, 5, 5) and merged.gates.bias is not None

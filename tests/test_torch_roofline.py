"""``video_prediction_torch.kernels.roofline``: the bytes of each kernel at
the shapes ``chip_smoke.py`` times (K2 a generator step of six calls; the
forward at batch 8, 32 and 64, the backward at the train step's 32; K3 at
3 candidates and the DNA op at ``dna_l2``'s batch 16), and the bound they
give. Byte counts: each input read once, each output written
once, fp32; the fp32 parameter tensors (K1's kernels, K2's ln_params and d
ln_params) are counted."""

import subprocess
import sys

import pytest

from video_prediction_torch.kernels import roofline as RL

LN_PARAMS_STEP = 10 * 4 * (64 + 128 + 256 + 128 + 64 + 32)  # [10,C] fp32 of the six widths: 26,880 bytes


@pytest.mark.parametrize("name, got, want_bytes, params_bytes, want_mb", [
    ("K1 fwd b8", RL.cdna_forward(8, 64, 64, 3), 1_969_280, 0, 1.97),
    ("K1 fwd b32", RL.cdna_forward(32, 64, 64, 3), 7_877_120, 0, 7.88),
    ("K1 fwd b64", RL.cdna_forward(64, 64, 64, 3), 15_754_240, 0, 15.75),
    ("K1 bwd b32", RL.cdna_backward(32, 64, 64, 3), 9_462_784, 0, 9.46),
    ("K2 fwd b8", RL.ln_gate_forward(RL.ln_gate_step(8)), 77_070_336, LN_PARAMS_STEP, 77.07),
    ("K2 fwd b32", RL.ln_gate_forward(RL.ln_gate_step(32)), 308_281_344, LN_PARAMS_STEP, 308.28),
    ("K2 fwd b64", RL.ln_gate_forward(RL.ln_gate_step(64)), 616_562_688, LN_PARAMS_STEP, 616.56),
    ("K2 bwd b32", RL.ln_gate_backward(RL.ln_gate_step(32)), 528_482_304, 2 * LN_PARAMS_STEP, 528.48),
    ("K3 fwd b8", RL.composite_forward(8, 7), 4_063_232, 0, 4.06),
    ("K3 fwd b32", RL.composite_forward(32, 7), 16_252_928, 0, 16.25),
    ("K3 fwd b64", RL.composite_forward(64, 7), 32_505_856, 0, 32.51),
    ("K3 bwd b32", RL.composite_backward(32, 7), 30_932_992, 0, 30.93),
    ("K3 fwd b16 K3", RL.composite_forward(16, 3), 3_932_160, 0, 3.93),
    ("K3 bwd b16 K3", RL.composite_backward(16, 3), 7_077_888, 0, 7.08),
    ("DNA fwd b16", RL.dna_forward(16, 64, 64, 3), 8_126_464, 0, 8.13),
    ("DNA bwd b16", RL.dna_backward(16, 64, 64, 3), 15_466_496, 0, 15.47),
])
def test_bytes(name, got, want_bytes, params_bytes, want_mb):
    """``want_bytes``: the activations' bytes, whose MB the kernel table
    prints; ``params_bytes``: K2's ln_params (and d ln_params) beside them."""
    nbytes, ops = got
    assert nbytes == want_bytes + params_bytes, name
    assert round(want_bytes / 1e6, 2) == pytest.approx(want_mb, abs=1e-9), name
    assert RL.bound_by(nbytes, ops) == "bytes", name  # far below the card's operations-per-byte line


def test_ln_gate_step_rows():
    """Rows of the six K2 calls of one generator step at batch 32 (64x64,
    ngf=32), and 28 C bytes a row forward, 48 C backward, in fp32."""
    step = RL.ln_gate_step(32)
    assert step == ((32768, 64), (8192, 128), (2048, 256), (8192, 128), (32768, 64), (131072, 32))
    rc = sum(r * c for r, c in step)
    assert RL.ln_gate_forward(step)[0] - LN_PARAMS_STEP == 28 * rc
    assert RL.ln_gate_backward(step)[0] - 2 * LN_PARAMS_STEP == 48 * rc
    assert RL.ln_gate_forward(step, itemsize=2)[0] - LN_PARAMS_STEP == 14 * rc  # bf16 halves the rows


@pytest.mark.parametrize("nbytes, ops, want_us", [
    (308_281_344, 0, 92.024),  # K2 forward at batch 32: bytes over 3.35e12 B/s
    (3_350_000_000, 0, 1000.0),
    (0, 67_000_000_000, 1000.0),  # an operation-bound case: ops over the fp32 rate
    (1_000, 67_000_000_000, 1000.0),
])
def test_bound_is_the_larger_of_bytes_and_operations(nbytes, ops, want_us):
    assert RL.HBM_BYTES_PER_S == 3.35e12
    assert RL.bound_ms(nbytes, ops) * 1e3 == pytest.approx(want_us, rel=1e-4)
    assert RL.bound_by(nbytes, ops) == ("bytes" if nbytes / 3.35e12 >= ops / 67e12 else "operations")


def test_imports_no_torch():
    """The module alone (loaded from its file, without the package's
    ``__init__``) imports nothing beyond the standard library."""
    code = ("import importlib.util, sys; spec = importlib.util.spec_from_file_location('roofline', sys.argv[1]); "
            "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy')))")
    out = subprocess.run([sys.executable, "-c", code, RL.__file__], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"

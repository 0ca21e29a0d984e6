"""K2's launch geometry (``video_prediction_torch/kernels/ln_gate.py#plan``)
on the CPU: at every flagship width and at C = 8, 40, 300 and 512, fp32 and
bf16, with aligned and unaligned tensors, forward and backward, each row and
each channel of a row is taken exactly once, the shared memory fits the
H100's 227 KB a block, and the grid gives the SMs work; the shared-memory
formula is the one ``csrc/ln_gate.cu#smem_bytes`` checks a plan against."""

import itertools

import pytest
import torch

from video_prediction_torch.kernels import ln_gate as L

torch.set_num_threads(1)

SMS = 132  # the H100's SMs
WIDTHS = [32, 64, 128, 256, 8, 40, 300, 512]


def occupancy(p: L.Plan) -> int:
    """A model of the device's answer: blocks by shared memory, at most 8."""
    return max(0, min(8, L.SMEM_LIMIT // p.smem))


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cdim", WIDTHS)
def test_plan_covers_every_row_and_channel_once(cdim, itemsize, aligned, backward):
    for rows in (77, 9001):
        p = L.plan(rows, cdim, itemsize, aligned, backward, SMS, occupancy)
        vector = cdim in L.VECTOR_WIDTHS and aligned
        assert (p.width, p.vec) == ((cdim, 16 // itemsize) if vector else (0, 1))
        assert p.lanes * p.rows_per_warp == 32 and p.stages == (2 if vector else 1)
        if vector:  # 16-byte chunks on clamp(C/V, 4, 32) lanes, nothing masked
            assert p.lanes == min(32, max(4, cdim // p.vec)) and p.per_lane * p.lanes == cdim
            assert p.per_lane % p.vec == 0
        else:  # one row a warp, the smallest power of two of values a lane
            assert p.lanes == 32 and 32 * p.per_lane >= cdim and (p.per_lane == 1 or 16 * p.per_lane < cdim)
        channels = [ch for lane in range(p.lanes) for ch in L.lane_channels(p, cdim, lane)]
        assert sorted(channels) == list(range(cdim))
        taken = [r for b in range(p.blocks) for w in range(p.warps) for r in L.warp_rows(p, rows, b, w)]
        assert sorted(taken) == list(range(rows))
        assert p.smem == L.smem_bytes(p.rows_per_warp, p.per_lane, cdim, itemsize, backward, p.warps, p.stages)
        assert p.smem <= L.SMEM_LIMIT
        staged = p.warps * p.stages * p.rows_per_warp * (7 if backward else 5) * cdim * itemsize
        assert p.smem >= staged + 40 * cdim + (p.warps * 10 * p.per_lane * 32 * 4 if backward else 0)
        assert 1 <= p.blocks <= occupancy(p) * SMS and p.tiles == -(-rows // p.rows_per_warp)
        assert 1 <= p.warps <= L.MAX_WARPS and p.warps & (p.warps - 1) == 0


@pytest.mark.parametrize("cdim, rows", [(256, 8 * 64), (128, 8 * 256), (32, 8 * 4096), (64, 32 * 1024)])
def test_plan_gives_every_sm_work(cdim, rows):
    """Fewer warps a block where the tiles are few (the batch-8 rollout's
    C=256 has 512 rows), so that the grid spans the SMs; a persistent grid of
    what fits where they are many."""
    p = L.plan(rows, cdim, 4, True, False, SMS, occupancy)
    assert p.blocks >= min(SMS, p.tiles)
    assert p.blocks == min(-(-p.tiles // p.warps), occupancy(p) * SMS)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
def test_plan_matches_the_instantiations(itemsize):
    """The plan's values a lane at each flagship width are the ones
    ``csrc/ln_gate.cu#vec_vpt`` instantiates (the launchers refuse any
    other), and every other plan asks for one of the run-time
    instantiations' 1, 2, 4, 8 or 16."""
    for cdim in L.VECTOR_WIDTHS:
        v = 16 // itemsize
        want = cdim // min(32, max(4, cdim // v))
        assert L.plan(4096, cdim, itemsize, True, True, SMS, occupancy).per_lane == want
    for cdim in range(1, L.MAX_CHANNELS + 1, 7):
        assert L.plan(4096, cdim, itemsize, False, True, SMS, occupancy).per_lane in (1, 2, 4, 8, 16)


def test_plan_refuses_what_no_sm_holds():
    with pytest.raises(ValueError, match="fits no block"):
        L.plan(4096, 256, 4, True, True, SMS, lambda p: 0)


@pytest.mark.parametrize("rows_per_warp, per_lane, cdim, itemsize, backward, warps, stages, want", [
    # two 8-byte mbarriers a warp; ln_params 40 C; rings of 5 C (7 C) a row; d ln slices 10 x per_lane x 32 fp32
    (4, 4, 32, 4, False, 8, 2, 128 + 1280 + 8 * 2 * 2560),
    (4, 4, 32, 4, True, 8, 2, 128 + 1280 + 8 * 2 * 3584 + 8 * 5120),
    (1, 8, 256, 4, True, 8, 2, 128 + 10240 + 8 * 2 * 7168 + 8 * 10240),
    (1, 16, 300, 2, True, 4, 1, 64 + 12000 + 4 * 4208 + 4 * 20480),  # 7 * 300 * 2 = 4200, padded to 16
])
def test_smem_bytes(rows_per_warp, per_lane, cdim, itemsize, backward, warps, stages, want):
    assert L.smem_bytes(rows_per_warp, per_lane, cdim, itemsize, backward, warps, stages) == want


def test_flagship_plans_fit_two_blocks_an_sm_in_fp32():
    """The fp32 forward at every flagship width, and the backward below
    C=256, leave room for two 256-thread blocks on an SM."""
    for cdim, backward in itertools.product(L.VECTOR_WIDTHS, (False, True)):
        p = L.plan(1 << 17, cdim, 4, True, backward, SMS, occupancy)
        if not (backward and cdim == 256):
            assert 2 * p.smem <= L.SMEM_LIMIT, (cdim, backward, p)

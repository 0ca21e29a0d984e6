"""K3 forward's launch geometry (``video_prediction_torch/kernels/composite.py#plan``)
on the CPU: at K = 1, 6, 7 and 16, C = 1, 3 and 4, 64x64 and 33x31 images,
fp32 and bf16, aligned and unaligned tensors, batches 8, 32 and 64, each
pixel and each output channel is taken exactly once, the shared memory fits
(the 48 KB a block gets without opting in, under the H100's 227 KB), batch 8
gives every SM a block, and the compile-time instantiation is taken exactly
for the zoo's aligned shapes; the shared-memory formula is the one
``csrc/composite.cu#forward_smem_bytes`` checks a plan against."""

import importlib

import pytest
import torch

# the module, not ``kernels.composite``, the wrapper function of the same name
K3 = importlib.import_module("video_prediction_torch.kernels.composite")

torch.set_num_threads(1)

SMS = 132  # the H100's SMs
SMEM_DEFAULT = 48 * 1024  # dynamic shared memory a block gets without opting in (the launcher's limit)


@pytest.mark.parametrize("batch", [8, 32, 64])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw", [(64, 64), (33, 31)], ids=["64x64", "33x31"])
@pytest.mark.parametrize("cdim", [1, 3, 4])
@pytest.mark.parametrize("k", [1, 6, 7, 16])
def test_plan_covers_every_pixel_and_channel_once(k, cdim, hw, itemsize, aligned, batch):
    pixels = hw[0] * hw[1]
    p = K3.plan(batch, pixels, k, cdim, itemsize, aligned, SMS)
    zoo = (k, cdim) in ((7, 3), (6, 3)) and aligned and hw == (64, 64)
    assert p.staged == (k if zoo else 0)
    assert p.tile in (K3.MIN_TILE, K3.MAX_TILE) and p.tiles == -(-pixels // p.tile) and p.blocks == batch * p.tiles
    assert p.blocks >= SMS  # batch 8 too: 512 tiles at 64x64, 256 at 33x31
    assert p.smem == K3.smem_bytes(bool(p.staged), p.tile, k, cdim, itemsize)
    assert p.smem <= SMEM_DEFAULT  # under the H100's 227 KB, with no attribute set at launch
    if p.staged:  # every staged slice a whole number of 16-byte chunks, no ragged tile
        assert pixels % p.tile == 0
        assert (p.tile * cdim * itemsize) % 16 == 0 and (p.tile * k * itemsize) % 16 == 0 and (p.tile * k * 4) % 16 == 0
    # every (sample, pixel) in one block's tile, and within a tile of n
    # pixels (full, or the ragged last one) every output channel from one thread
    owners = torch.zeros(batch, pixels, dtype=torch.int32)
    sizes = set()
    for block in range(p.blocks):
        b, pix = K3.tile_pixels(p, pixels, block)
        assert 0 < len(pix) <= p.tile and pix == list(range(pix[0], pix[0] + len(pix)))
        owners[b, pix[0]:pix[-1] + 1] += 1
        sizes.add(len(pix))
    assert bool((owners == 1).all())
    for n in sizes:
        taken = sorted(j for thread in range(p.tile) for j in K3.thread_outputs(p, n, cdim, itemsize, thread))
        assert taken == list(range(n * cdim)), (n, p)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
def test_staged_threads_write_16_byte_chunks(itemsize):
    """A staged tile's outputs go out as 16-byte chunks (4 fp32 or 8 bf16
    values), one a thread, contiguous, none straddling the tile's end."""
    p = K3.plan(8, 4096, 7, 3, itemsize, True, SMS)
    vec = 16 // itemsize
    chunks = [K3.thread_outputs(p, p.tile, 3, itemsize, thread) for thread in range(p.tile)]
    assert sum(1 for js in chunks if js) == p.tile * 3 // vec  # 48 fp32, 24 bf16 of 64 threads
    for js in chunks:
        assert js in ([], list(range(js[0] if js else 0, (js[0] if js else 0) + vec)))
        assert not js or (js[0] % vec == 0 and js[-1] < p.tile * 3)


@pytest.mark.parametrize("batch, pixels, want", [
    (8, 4096, 64), (32, 4096, 64), (1, 4096, 32),  # 64 tiles of 64 would leave SMs idle; 32 is the least
    (8, 1023, 32), (64, 1023, 64), (2, 1023, 32),
])
def test_tile_halves_where_the_tiles_would_not_cover_the_sms(batch, pixels, want):
    assert K3.plan(batch, pixels, 7, 3, 4, True, SMS).tile == want


@pytest.mark.parametrize("staged, tile, k, cdim, itemsize, want", [
    # mbarrier 16; candidates K*TP*C and logits TP*K in the dtype; weights TP*K fp32
    (True, 64, 7, 3, 4, 16 + 5376 + 1792 + 1792),
    (True, 64, 6, 3, 2, 16 + 2304 + 768 + 1536),
    (True, 32, 7, 3, 2, 16 + 1344 + 448 + 896),
    (False, 64, 16, 4, 4, 64 * 16 * 4),  # run time: the weights only
    (False, 32, 1, 1, 2, 128),
])
def test_smem_bytes(staged, tile, k, cdim, itemsize, want):
    assert K3.smem_bytes(staged, tile, k, cdim, itemsize) == want


def test_only_the_zoo_shapes_are_staged():
    """The compile-time instantiations are K = 7 and 6 at C = 3 with H*W a
    multiple of 64 and aligned tensors; a K or C next to them, another H*W,
    or one unaligned tensor takes the run-time one."""
    for k in range(1, K3.MAX_CANDIDATES + 1):
        for cdim in (1, 2, 3, 4, 8):
            for pixels, aligned in ((4096, True), (16384, True), (4096, False), (4032 + 32, True), (1023, True)):
                p = K3.plan(8, pixels, k, cdim, 4, aligned, SMS)
                zoo = (k, cdim) in ((7, 3), (6, 3)) and aligned and pixels % 64 == 0
                assert p.staged == (k if zoo else 0), (k, cdim, pixels, aligned)

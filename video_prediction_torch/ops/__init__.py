"""Primitive ops: layers, normalization, ConvRNN cells, CDNA/DNA/flow
kernels, NHWC as in the JAX package. Re-exports the public names of
``video_prediction_tpu/ops/__init__.py``, all of them."""

from video_prediction_torch.ops.layers import (  # noqa: F401
    Dense,
    Conv2D,
    Conv3D,
    ConvTranspose2D,
    UpsampleConv2D,
    ConvPool2D,
    Local2D,
    SeparableLocal2D,
    local2d_apply,
    separable_local2d_apply,
    lrelu,
    pool2d,
    upsample2d,
    get_norm_layer,
    get_activation,
    get_upsample_layer,
    get_downsample_layer,
)
from video_prediction_torch.ops.spectral import (  # noqa: F401
    SpectralDense,
    SpectralConv2D,
    SpectralConv3D,
    spectral_normalize,
)
from video_prediction_torch.ops.rnn import ConvLSTMCell, ConvGRUCell  # noqa: F401
from video_prediction_torch.ops.cdna import (  # noqa: F401
    apply_cdna_kernels,
    apply_dna_kernels,
    identity_kernel,
    normalize_kernels,
)
from video_prediction_torch.ops.warp import (  # noqa: F401
    apply_affine_kernels,
    bilinear_sample,
    flow_to_warp_grid,
    image_warp,
)

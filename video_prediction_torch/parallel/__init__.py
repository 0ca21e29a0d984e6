"""Training across processes: the process group (``distributed.py``), the
rows, noise, gradients and parameters each rank holds of it and the spatial
mesh (``mesh.py``), and the halo exchanges and gathers of spatial
partitioning (``spatial.py``). Counterpart of ``video_prediction_tpu/parallel/``.

Re-exports the public names of ``video_prediction_tpu/parallel/__init__.py``
but ``JAX_ONLY``, the helpers of a ``jax.sharding`` device mesh, which a
process group has no counterpart of: ``make_mesh``, ``mesh_for_batch``,
``batch_sharding``, ``batch_shardings``, ``leaf_spec``,
``replicated_sharding`` and ``spatial_mesh`` (the port builds its spatial
mesh with ``mesh.make_spatial_mesh``)."""

from video_prediction_torch.parallel.distributed import maybe_initialize, per_host_batch  # noqa: F401
from video_prediction_torch.parallel.mesh import shard_batch  # noqa: F401

JAX_ONLY = ("make_mesh", "mesh_for_batch", "batch_sharding", "batch_shardings", "leaf_spec", "replicated_sharding",
            "spatial_mesh")

"""Training across processes: the process group (``distributed.py``), the
rows, noise, gradients and parameters each rank holds of it and the spatial
mesh (``mesh.py``), and the halo exchanges and gathers of spatial
partitioning (``spatial.py``). Counterpart of ``video_prediction_tpu/parallel/``."""

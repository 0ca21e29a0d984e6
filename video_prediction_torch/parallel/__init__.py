"""Data-parallel training across processes: the process group
(``distributed.py``) and the rows, noise, gradients and parameters each rank
holds of it (``mesh.py``). Counterpart of ``video_prediction_tpu/parallel/``
(its data axis; spatial partitioning is not ported yet)."""

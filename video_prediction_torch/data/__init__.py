"""Dataset registry (reference ``video_prediction/datasets/__init__.py#
get_dataset_class``). The port has the file-free ``synthetic`` dataset; the
TFRecord readers of the JAX package are still to be ported (ROADMAP.md)."""

from video_prediction_torch.data.synthetic import SyntheticVideoDataset  # noqa: F401

_DATASETS = {
    "synthetic": SyntheticVideoDataset,
}


def get_dataset_class(name: str):
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset {name!r}; available: {sorted(_DATASETS)}")
    return _DATASETS[name]

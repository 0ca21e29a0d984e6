"""Hyperparameter dataclasses and the hparams zoo (copied from the JAX package)."""

"""Data pipelines."""
from .synthetic import SyntheticLMDataset, make_batch_iterator  # noqa: F401

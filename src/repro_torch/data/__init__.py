"""The training data pipeline: a copy of the JAX package's numpy-only
``repro/data/pipeline.py`` (batches are numpy arrays, a pure function of
(seed, step), so both packages draw the same batches bit for bit)."""

from .pipeline import DataConfig, SyntheticLMData, make_pipeline  # noqa: F401

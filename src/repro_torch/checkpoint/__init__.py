"""Checkpoints of the training state in the JAX package's format (see
`ckpt`)."""

from .ckpt import (CheckpointManager, latest_step,  # noqa: F401
                   load_checkpoint, save_checkpoint)

"""Checkpoints in the JAX package's file layout (counterpart of
``repro.checkpoint``): a run saved by either package resumes in the
other."""

from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]

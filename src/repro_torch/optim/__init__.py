"""Optimizers beside SP-NGD (counterpart of ``repro/optim``): the
momentum-SGD baseline and the learning-rate schedules."""

from repro_torch.optim.sgd import SGD

__all__ = ["SGD"]

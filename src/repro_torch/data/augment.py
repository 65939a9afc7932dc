"""Data augmentation of the paper's section 6.1, running mixup and random
erasing (counterpart of ``repro/data/augment.py``). The random draws come
from the same ``np.random.RandomState`` calls in the same order as the JAX
package's, so one seed gives both packages the same batch; the arithmetic
runs on the images' device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


class RunningMixup:
    """Paper Eq. 18-19: virtual samples are mixed from the previous step's
    virtual samples, not just raw samples:

        x~(t) = lam * x(t) + (1 - lam) * x~(t-1)
        t~(t) = lam * t(t) + (1 - lam) * t~(t-1)

    lam ~ Beta(alpha, alpha). Hard labels become one-hot f32."""

    def __init__(self, alpha: float, n_classes: int, seed: int = 0):
        self.alpha = alpha
        self.n_classes = n_classes
        self.rng = np.random.RandomState(seed)
        self.prev_x: Optional[torch.Tensor] = None
        self.prev_t: Optional[torch.Tensor] = None

    def __call__(self, images: torch.Tensor, labels: torch.Tensor) -> tuple:
        soft = (F.one_hot(labels.long(), self.n_classes).float()
                if labels.dim() == 1 else labels)
        if self.prev_x is None:
            self.prev_x, self.prev_t = images, soft
            return images, soft
        lam = float(self.rng.beta(self.alpha, self.alpha))
        x = lam * images + (1 - lam) * self.prev_x
        t = lam * soft + (1 - lam) * self.prev_t
        self.prev_x, self.prev_t = x, t
        return x, t


def erase_mask(rng: np.random.RandomState, b: int, h: int, w: int, *,
               p: float = 0.5, area: tuple = (0.02, 0.25),
               aspect: tuple = (0.3, 1.0)) -> np.ndarray:
    """The erased pixels of a (b, h, w) batch, as a bool mask: per image,
    with probability p, a rectangle of area fraction U(area) and aspect
    U(aspect), (He, We) swapped with probability 1/2, at a uniform
    position."""
    mask = np.zeros((b, h, w), bool)
    for i in range(b):
        if rng.rand() >= p:
            continue
        se = rng.uniform(*area) * h * w
        re = rng.uniform(*aspect)
        he = int(round(np.sqrt(se * re)))
        we = int(round(np.sqrt(se / re)))
        if rng.rand() < 0.5:
            he, we = we, he
        he, we = min(he, h), min(we, w)
        if he < 1 or we < 1:
            continue
        y0 = rng.randint(0, h - he + 1)
        x0 = rng.randint(0, w - we + 1)
        mask[i, y0:y0 + he, x0:x0 + we] = True
    return mask


def random_erase(rng: np.random.RandomState, images: torch.Tensor, *,
                 p: float = 0.5, area: tuple = (0.02, 0.25),
                 aspect: tuple = (0.3, 1.0)) -> torch.Tensor:
    """Paper section 6.1's Random Erasing with zero value on a channels-last
    batch (B, H, W, C): the rectangles drawn on the host
    (:func:`erase_mask`), the zeros applied on the images' device. Returns
    a new tensor."""
    b, h, w, _ = images.shape
    mask = erase_mask(rng, b, h, w, p=p, area=area, aspect=aspect)
    keep = torch.from_numpy(mask).to(images.device)[..., None]
    return images.masked_fill(keep, 0.0)

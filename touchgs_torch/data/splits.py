"""Train/eval split logic (port of ``touchgs_tpu/data/splits.py``).

Two linspace variants exist in the reference and they intentionally differ:

- trainer split (``legacy/dataparser_tactile.py:199-214``):
  ``i_train = linspace(0, n-1, num_train, dtype=int)``
- point-cloud seeding split (``utils/create_point_cloud_from_touches.py:174-198``):
  ``i_train = linspace(0, n-1, num_train+1, dtype=int)[:-1]``

Both are kept, so touch seeds come from the views the reference seeds from
while the trainer splits like the fork's dataparser.
"""
from __future__ import annotations

import math

import numpy as np


def linspace_split(
    num_images: int, train_split_fraction: float, variant: str = "dataparser"
) -> tuple[np.ndarray, np.ndarray]:
    """Equally-spaced train indices; the rest are eval.

    variant: "dataparser" (trainer) or "seeding" (touch point cloud).
    """
    num_train = math.ceil(num_images * train_split_fraction)
    i_all = np.arange(num_images)
    if variant == "dataparser":
        i_train = np.linspace(0, num_images - 1, num_train, dtype=int)
    elif variant == "seeding":
        i_train = np.linspace(0, num_images - 1, num_train + 1, dtype=int)[:-1]
    else:
        raise ValueError(f"unknown split variant {variant!r}")
    i_eval = np.setdiff1d(i_all, i_train)
    return i_train, i_eval

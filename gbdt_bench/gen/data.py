"""The rows a cell trains and validates on, as its generator made them."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class Data:
    x_train: torch.Tensor                 # [N, F] f32
    y_train: torch.Tensor                 # [N] f32
    x_valid: torch.Tensor                 # [Nv, F] f32
    y_valid: torch.Tensor                 # [Nv] f32
    group_train: Optional[np.ndarray] = None   # query sizes, or None
    group_valid: Optional[np.ndarray] = None

    def to(self, device) -> "Data":
        return Data(self.x_train.to(device), self.y_train.to(device),
                    self.x_valid.to(device), self.y_valid.to(device),
                    self.group_train, self.group_valid)


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded with any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g

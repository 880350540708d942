"""Train state container (the port of ``repro.train.train_state``)."""
from __future__ import annotations

from typing import Any, NamedTuple

from .optimizer import AdamWState

__all__ = ["TrainState"]


class TrainState(NamedTuple):
    params: Any                 # a module or a nested dict of tensors
    opt: AdamWState
    rng: Any                    # a torch.Generator or an int seed

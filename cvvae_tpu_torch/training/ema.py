"""Exponential moving average of parameters.

Port of ``cvvae_tpu/training/ema.py`` (LitEma): shadow parameters with
the warm-up decay min(decay, (1 + n) / (10 + n)).  The shadow is a dict
of tensors keyed by parameter name, updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class EMAState:
    shadow: Dict[str, torch.Tensor]
    num_updates: int

    def state_dict(self) -> dict:
        return {"shadow": dict(self.shadow), "num_updates": self.num_updates}


def ema_init(params: Dict[str, torch.Tensor]) -> EMAState:
    return EMAState({k: p.detach().clone() for k, p in params.items()}, 0)


@torch.no_grad()
def ema_update(state: EMAState, params: Dict[str, torch.Tensor],
               decay: float = 0.9999) -> EMAState:
    state.num_updates += 1
    n = torch.tensor(state.num_updates, dtype=torch.float32)
    d = float(torch.minimum(torch.tensor(decay, dtype=torch.float32),
                            (1.0 + n) / (10.0 + n)))
    for k, s in state.shadow.items():
        s.sub_((1.0 - d) * (s - params[k].to(s.dtype)))
    return state

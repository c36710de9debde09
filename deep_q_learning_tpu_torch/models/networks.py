"""Q-value network (``deep_q_learning_tpu/models/networks.py``) as an
``nn.Module``.

An MLP trunk with ReLU and either a dueling head (``Q = V + A - mean_a A``)
or a plain linear head.  Initialisation is flax's ``nn.Dense`` default, not
``nn.Linear``'s: lecun-normal kernels (a normal truncated at two standard
deviations, scaled to variance ``1 / fan_in``) and zero biases.  Layer
names follow the flax module (``trunk_{i}``, ``value``, ``advantage``,
``q``), and :meth:`QNetwork.from_flax_params` loads a flax parameter dict.
The network runs in float32.
"""

from __future__ import annotations

import math
from typing import Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# stddev of a unit normal truncated to [-2, 2]; flax divides by it so the
# truncated draw has the requested variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal`` for a ``(out, in)`` torch weight, in place."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return weight


def _linear(n_in: int, n_out: int, device) -> nn.Linear:
    # parameters are set by reset_parameters; skip nn.Linear's own init
    return nn.utils.skip_init(nn.Linear, n_in, n_out, device=device or "cpu")


class QNetwork(nn.Module):
    """MLP Q-network with an optional dueling head."""

    def __init__(
        self,
        obs_dim: int,
        num_actions: int,
        hidden: Sequence[int] = (256, 256),
        dueling: bool = True,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.dueling = dueling
        widths = (obs_dim,) + self.hidden
        self.trunk = nn.ModuleList(
            _linear(widths[i], widths[i + 1], device) for i in range(len(self.hidden))
        )
        if dueling:
            self.value = _linear(widths[-1], 1, device)
            self.advantage = _linear(widths[-1], num_actions, device)
        else:
            self.q = _linear(widths[-1], num_actions, device)
        self.reset_parameters(generator)

    def flax_layers(self) -> Iterator[Tuple[str, nn.Linear]]:
        """``(flax layer name, layer)`` pairs in forward order."""
        for i, layer in enumerate(self.trunk):
            yield f"trunk_{i}", layer
        if self.dueling:
            yield "value", self.value
            yield "advantage", self.advantage
        else:
            yield "q", self.q

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax ``nn.Dense`` init: lecun-normal kernels, zero biases.  Draws
        come from ``generator``, which must be on the parameters' device."""
        for _, layer in self.flax_layers():
            lecun_normal_(layer.weight, generator)
            with torch.no_grad():
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.trunk:
            x = torch.relu(layer(x))
        if self.dueling:
            val = self.value(x)
            adv = self.advantage(x)
            return val + adv - adv.mean(dim=-1, keepdim=True)
        return self.q(x)

    @classmethod
    def from_flax_params(cls, params: Mapping, device=None) -> "QNetwork":
        """Build a network from a flax ``QNetwork`` parameter dict whose
        leaves are numpy arrays (``{"params": {"trunk_0": {"kernel", "bias"},
        ...}}`` or its inner dict).  Each ``(in, out)`` kernel becomes an
        ``(out, in)`` weight."""
        p = params.get("params", params)
        n_trunk = sum(1 for k in p if k.startswith("trunk_"))
        hidden = tuple(np.shape(p[f"trunk_{i}"]["bias"])[0] for i in range(n_trunk))
        dueling = "value" in p
        head = p["advantage"] if dueling else p["q"]
        net = cls(
            obs_dim=np.shape(p["trunk_0"]["kernel"])[0],
            num_actions=np.shape(head["bias"])[0],
            hidden=hidden,
            dueling=dueling,
            device=device,
        )
        with torch.no_grad():
            for name, layer in net.flax_layers():
                kernel = np.asarray(p[name]["kernel"], np.float32)
                layer.weight.copy_(torch.tensor(kernel.T))
                layer.bias.copy_(torch.tensor(np.asarray(p[name]["bias"], np.float32)))
        return net

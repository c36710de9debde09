"""Q-value network (``deep_q_learning_tpu/models/networks.py``) as an
``nn.Module``.

An MLP trunk with ReLU and either a dueling head (``Q = V + A - mean_a A``)
or a plain linear head.  Initialisation is flax's ``nn.Dense`` default, not
``nn.Linear``'s: lecun-normal kernels (a normal truncated at two standard
deviations, scaled to variance ``1 / fan_in``) and zero biases.  Layer
names follow the flax module (``trunk_{i}``, ``value``, ``advantage``,
``q``), and :meth:`QNetwork.from_flax_params` loads a flax parameter dict.

``compute_dtype="bfloat16"`` runs the trunk in bf16, as flax's
``QNetwork(compute_dtype=bfloat16)``: the input, weights, biases and
activations are bf16, the heads run in float32 on the bf16 features cast
up, and Q is float32.  Parameters (and so gradients and optimizer state)
stay float32: the weights are cast at use, not in storage.  flax's
``Dense(dtype=bf16)`` rounds ``x·W`` to bf16 and then adds the bias in
bf16, so it rounds twice; ``F.linear`` and ``baddbmm`` would add the bias
before the one rounding, so the bf16 trunk runs the product and the bias
add as two ops.  The float32 path is unchanged.

:class:`MemberQNetwork` is M such networks of one shape for a population
(``parallel/population.py``): each layer holds an (M, out, in) weight and
an (M, out) bias, and a forward is one ``torch.baddbmm`` a layer over
(M, rows, in) inputs, where the JAX package ``jax.vmap``s the network.
"""

from __future__ import annotations

import math
from typing import Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype``; raises for any name
    but "float32" and "bfloat16"."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


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
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.dueling = dueling
        self.compute_dtype = compute_dtype_of(compute_dtype)
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

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk's activations, in ``compute_dtype``."""
        if self.compute_dtype == torch.float32:
            for layer in self.trunk:
                x = torch.relu(layer(x))
            return x
        dt = self.compute_dtype
        x = x.to(dt)
        for layer in self.trunk:
            x = torch.relu(torch.matmul(x, layer.weight.to(dt).t()) + layer.bias.to(dt))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x).to(torch.float32)
        if self.dueling:
            val = self.value(x)
            adv = self.advantage(x)
            return val + adv - adv.mean(dim=-1, keepdim=True)
        return self.q(x)

    @classmethod
    def from_flax_params(
        cls, params: Mapping, device=None, compute_dtype: str = "float32"
    ) -> "QNetwork":
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
            compute_dtype=compute_dtype,
        )
        with torch.no_grad():
            for name, layer in net.flax_layers():
                kernel = np.asarray(p[name]["kernel"], np.float32)
                layer.weight.copy_(torch.tensor(kernel.T))
                layer.bias.copy_(torch.tensor(np.asarray(p[name]["bias"], np.float32)))
        return net


class MemberLinear(nn.Module):
    """M ``nn.Linear`` layers of one shape: ``weight`` (M, out, in), ``bias``
    (M, out); ``x`` (M, rows, in) -> (M, rows, out)."""

    def __init__(self, members: int, n_in: int, n_out: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((members, n_out, n_in), device=device))
        self.bias = nn.Parameter(torch.empty((members, n_out), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return torch.baddbmm(self.bias[:, None, :], x, self.weight.transpose(1, 2))
        # a reduced-precision trunk: the product rounded, then the bias added
        dt = x.dtype
        return torch.bmm(x, self.weight.to(dt).transpose(1, 2)) + self.bias.to(dt)[:, None, :]


class MemberQNetwork(nn.Module):
    """M independent :class:`QNetwork` s with stacked parameters.  The
    parameters come in the order of one network's, each with a leading
    member axis, so an optimizer handles them leaf by leaf with per-member
    reductions."""

    def __init__(
        self,
        members: int,
        obs_dim: int,
        num_actions: int,
        hidden: Sequence[int] = (256, 256),
        dueling: bool = True,
        device=None,
        generators: Optional[Sequence[torch.Generator]] = None,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.members = members
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.dueling = dueling
        self.compute_dtype = compute_dtype_of(compute_dtype)
        widths = (obs_dim,) + self.hidden
        self.trunk = nn.ModuleList(
            MemberLinear(members, widths[i], widths[i + 1], device)
            for i in range(len(self.hidden))
        )
        if dueling:
            self.value = MemberLinear(members, widths[-1], 1, device)
            self.advantage = MemberLinear(members, widths[-1], num_actions, device)
        else:
            self.q = MemberLinear(members, widths[-1], num_actions, device)
        self.reset_parameters(generators)

    flax_layers = QNetwork.flax_layers

    def reset_parameters(self, generators: Optional[Sequence[torch.Generator]] = None) -> None:
        """Member ``m`` initialised as ``QNetwork.reset_parameters(generators[m])``
        initialises one network: its layers in order from its own generator."""
        gens = list(generators) if generators is not None else [None] * self.members
        if len(gens) != self.members:
            raise ValueError(f"{len(gens)} generators for {self.members} members")
        with torch.no_grad():
            for m, generator in enumerate(gens):
                for _, layer in self.flax_layers():
                    lecun_normal_(layer.weight[m], generator)
            for _, layer in self.flax_layers():
                layer.bias.zero_()

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk's activations (M, rows, width), in ``compute_dtype``."""
        x = x.to(self.compute_dtype)
        for layer in self.trunk:
            x = torch.relu(layer(x))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (M, rows, obs_dim) -> Q-values (M, rows, num_actions)."""
        x = self.features(x).to(torch.float32)
        if self.dueling:
            val = self.value(x)
            adv = self.advantage(x)
            return val + adv - adv.mean(dim=-1, keepdim=True)
        return self.q(x)

    @classmethod
    def from_flax_params(
        cls, params: Mapping, device=None, compute_dtype: str = "float32"
    ) -> "MemberQNetwork":
        """Stacked networks from a member-stacked flax ``QNetwork`` parameter
        dict (as ``jax.vmap(network.init)`` gives: every leaf with a leading
        member axis, ``kernel`` (M, in, out)); numpy leaves."""
        p = params.get("params", params)
        n_trunk = sum(1 for k in p if k.startswith("trunk_"))
        members, obs_dim, _ = np.shape(p["trunk_0"]["kernel"])
        hidden = tuple(np.shape(p[f"trunk_{i}"]["bias"])[1] for i in range(n_trunk))
        dueling = "value" in p
        head = p["advantage"] if dueling else p["q"]
        net = cls(members, obs_dim, np.shape(head["bias"])[1], hidden, dueling, device=device,
                  compute_dtype=compute_dtype)
        with torch.no_grad():
            for name, layer in net.flax_layers():
                kernel = np.asarray(p[name]["kernel"], np.float32)
                layer.weight.copy_(torch.tensor(kernel.transpose(0, 2, 1)))
                layer.bias.copy_(torch.tensor(np.asarray(p[name]["bias"], np.float32)))
        return net

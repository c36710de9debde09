"""DQN learner (``deep_q_learning_tpu/algos/dqn.py``): runtime
hyperparameters, train state, an optimizer with optax semantics, the update
step and the ε schedules.

Optimizer semantics follow optax, not ``torch.optim`` (ROADMAP.md, "Optimizer
and init defaults"):
  * ``clip_by_global_norm(m)`` leaves the gradients alone when the global
    norm is below ``m`` and scales them by ``m / norm`` otherwise;
  * adam bias-corrects both moments and adds ``eps`` outside the sqrt;
  * adamw's weight decay defaults to 1e-4 and is added to the adam update
    before the learning-rate scale; rmsprop adds ``eps`` inside the sqrt
    with decay 0.9.
The learning rate and the clip norm are read from :class:`HyperParams` at
every update, as ``optax.inject_hyperparams`` allows in the JAX package.
The Adam count lives on the device (``OptState.device_count``, int32 as
optax's; (M,) for a population) and its bias corrections ``1 - decay**count``
are read there from a table of optax's float32 values
(:func:`bias_correction_table`), so that an update launches kernels only and
runs inside a CUDA graph (``algos/superstep.py``); ``OptState.count`` and
``TrainState.updates`` are its host mirrors.

A population of M learners (``parallel/population.py``) runs the same
functions on member-stacked state: :class:`MemberHyperParams`, networks
with a leading member axis (``models.MemberQNetwork``), and a ``mask`` of
the members whose train gate is open (an (M,) bool tensor on the device, or
M host bools).  Every reduction is per member (the
clip's global norm, Adam's bias correction from each member's own count),
and a member whose gate is closed keeps its parameters, moments, count
and target, as under ``jax.vmap`` a closed ``lax.cond`` is a select.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deep_q_learning_tpu_torch.algos.losses import build_loss_fn
from deep_q_learning_tpu_torch.envs.graphed import device_mirror
from deep_q_learning_tpu_torch.replay.nstep import LearnBatch


@dataclasses.dataclass
class HyperParams:
    """Runtime hyperparameters, as Python numbers: changing one between
    supersteps changes no program structure."""

    gamma: float
    eps_start: float
    eps_min: float
    eps_decay: float
    eps_decay_steps: float
    learning_rate: float
    max_grad_norm: float  # unused when cfg.max_grad_norm is None
    target_tau: float  # unused when cfg.target_tau is None (hard sync)
    per_beta: float
    train_every: int
    training_start: int
    target_sync_every: int
    target_replace_episodes: int

    @classmethod
    def from_config(cls, cfg) -> "HyperParams":
        return cls(
            gamma=float(cfg.gamma),
            eps_start=float(cfg.eps_start),
            eps_min=float(cfg.eps_min),
            eps_decay=float(cfg.eps_decay),
            eps_decay_steps=float(cfg.eps_decay_steps),
            learning_rate=float(cfg.learning_rate),
            max_grad_norm=math.inf if cfg.max_grad_norm is None else float(cfg.max_grad_norm),
            target_tau=0.0 if cfg.target_tau is None else float(cfg.target_tau),
            per_beta=float(cfg.per_beta),
            train_every=int(cfg.train_every),
            training_start=int(cfg.training_start),
            target_sync_every=int(cfg.target_sync_every),
            target_replace_episodes=int(cfg.target_replace_episodes),
        )


# the cadence fields: host ints, as the train and sync gates are host decisions
CADENCE_FIELDS = ("train_every", "training_start", "target_sync_every", "target_replace_episodes")


@dataclasses.dataclass
class MemberHyperParams:
    """The runtime hyperparameters of M population members: each float field
    an (M,) float32 tensor on the device, each cadence field a tuple of M
    host ints (:data:`CADENCE_FIELDS`).  Field names are
    :class:`HyperParams`'s."""

    gamma: torch.Tensor
    eps_start: torch.Tensor
    eps_min: torch.Tensor
    eps_decay: torch.Tensor
    eps_decay_steps: torch.Tensor
    learning_rate: torch.Tensor
    max_grad_norm: torch.Tensor
    target_tau: torch.Tensor
    per_beta: torch.Tensor
    train_every: Tuple[int, ...]
    training_start: Tuple[int, ...]
    target_sync_every: Tuple[int, ...]
    target_replace_episodes: Tuple[int, ...]

    @classmethod
    def from_config(cls, cfg, members: int, device) -> "MemberHyperParams":
        """The config's values, the same for every member."""
        h = HyperParams.from_config(cfg)
        return cls(**{
            f.name: (getattr(h, f.name),) * members if f.name in CADENCE_FIELDS
            else torch.full((members,), getattr(h, f.name), dtype=torch.float32, device=device)
            for f in dataclasses.fields(HyperParams)
        })


def _member_view(x, like: torch.Tensor):
    """A per-member (M,) tensor ``x`` viewed to broadcast over a
    member-stacked ``like`` (M, ...); anything else as it is."""
    if isinstance(x, torch.Tensor) and x.dim() == 1 and like.dim() > 1:
        return x.view((-1,) + (1,) * (like.dim() - 1))
    return x


def _masked_writer(mask: Optional[torch.Tensor]) -> Callable:
    """``write(buffer, value)`` storing ``value`` in place, only in the
    members whose device ``mask`` (M,) is True (everywhere if ``mask`` is
    None).  ``where(True, value, buf)`` is ``value`` bit for bit, so an open
    gate writes what an unmasked write would."""
    if mask is None:
        return lambda buf, value: buf.copy_(value)
    return lambda buf, value: buf.copy_(torch.where(_member_view(mask, buf), value, buf))


def _member_mask(mask, device) -> Tuple[Optional[torch.Tensor], Optional[List[bool]]]:
    """``(device mask, host gates)`` of a ``mask`` argument: an (M,) bool
    tensor as it is, with no host gates; a sequence of M host bools as a
    device tensor and the bools; None as None."""
    if mask is None or isinstance(mask, torch.Tensor):
        return mask, None
    gates = [bool(k) for k in mask]
    return torch.tensor(gates, device=device), gates


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


_BIAS_TABLES: dict = {}  # (decay, device): the table of bias_correction_table
_BIAS_TABLE_LIMIT = 1 << 20  # a decay whose correction reaches 1.0f later is refused


def bias_correction_table(decay: float, device) -> torch.Tensor:
    """Optax's float32 bias corrections for ``decay`` on ``device``: entry
    ``k`` is :func:`_bias_correction` ``(decay, k)``, from count 0 to the
    first count whose correction is exactly 1.0f (it stays 1.0f past it).
    Made once for each (decay, device) and kept."""
    device = torch.device(device)
    key = (float(decay), device)
    if key not in _BIAS_TABLES:
        values = [_bias_correction(decay, 0)]
        while values[-1] != 1.0:
            if len(values) == _BIAS_TABLE_LIMIT:
                raise ValueError(f"1 - {decay}**count is below 1.0f at count {_BIAS_TABLE_LIMIT}")
            values.append(_bias_correction(decay, len(values)))
        table = torch.tensor(values, dtype=torch.float32, device=device)
        assert np.float32(values[-1]) == 1 and table.numel() == len(values)
        _BIAS_TABLES[key] = table
    return _BIAS_TABLES[key]


def _device_bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """Optax's ``1 - decay**count`` in float32 at each device ``count`` (a
    () or (M,) int32 tensor; a count below 1 reads count 1's), in one
    gather from :func:`bias_correction_table`: kernels only, with no read
    back to the host."""
    table = bias_correction_table(decay, count.device)
    index = torch.clamp(count, 1, table.numel() - 1)
    return table.index_select(0, index.reshape(-1)).view(count.shape)


# ---------------------------------------------------------------------------
# Optimizer (optax semantics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptState:
    # updates applied (optax's int32 count): a host mirror of device_count;
    # a list of M for members
    count: int = device_mirror("device_count")
    mu: List[torch.Tensor]  # first moments (adam/adamw)
    nu: List[torch.Tensor]  # second moments (adam/adamw/rmsprop)
    device_count: Optional[torch.Tensor] = None  # () int32 on the device; (M,) for members


# optax's defaults for the constructors the JAX package calls with the
# learning rate alone (algos/dqn.py::_OPTIMIZERS there)
ADAM_B1, ADAM_B2, EPS = 0.9, 0.999, 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
RMSPROP_DECAY = 0.9


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), <ctor>(lr))`` as an
    in-place update of a list of parameter tensors."""

    def __init__(self, name: str, clip: bool):
        if name not in ("adam", "adamw", "rmsprop", "sgd"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.clip = clip

    def init(self, params: List[torch.Tensor], members: Optional[int] = None) -> OptState:
        """Zero moments; a count on the device and its host mirror, one for
        each of ``members`` if given.  Adam's bias-correction tables are
        made here, before any update is captured."""
        device = params[0].device
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        if self.name in ("adam", "adamw"):
            for decay in (ADAM_B1, ADAM_B2):
                bias_correction_table(decay, device)
        shape, count = ((), 0) if members is None else ((members,), [0] * members)
        return OptState(count=count, mu=zeros(), nu=zeros(),
                        device_count=torch.zeros(shape, dtype=torch.int32, device=device))

    @torch.no_grad()
    def apply(
        self,
        grads: List[torch.Tensor],
        state: OptState,
        params: List[torch.Tensor],
        learning_rate,
        max_grad_norm=math.inf,
        mask=None,
        advance: bool = True,
    ) -> None:
        """Update ``params`` and ``state`` in place from ``grads``.

        The count advances on the device, and its host mirror with it unless
        ``advance`` is False (a caller inside a CUDA graph advances the
        mirror itself).  With ``mask`` (an (M,) bool tensor or M host bools)
        the parameters are member-stacked: the clip's global norm is each
        member's over all its leaves, ``learning_rate`` and
        ``max_grad_norm`` are (M,) tensors, each member's count
        bias-corrects its own Adam moments, and a member whose mask is
        False keeps its parameters, moments and count.  A mask given as a
        tensor advances no host mirror: pass ``advance=False``."""
        grads = list(grads)
        mask, gates = _member_mask(mask, params[0].device)
        if mask is not None and advance and gates is None:
            raise ValueError("a device mask advances no host mirror: pass advance=False")
        write = _masked_writer(mask)
        per = _member_view
        if self.clip:
            if mask is None:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            else:
                norm = torch.sqrt(sum((g * g).flatten(1).sum(dim=1) for g in grads))
            grads = [
                torch.where(per(norm, g) < per(max_grad_norm, g), g,
                            g / per(norm, g) * per(max_grad_norm, g))
                for g in grads
            ]
        state.device_count.add_(1 if mask is None else mask)
        if advance:
            state.count = (state.count + 1 if mask is None
                           else [c + k for c, k in zip(state.count, gates)])
        if self.name in ("adam", "adamw"):
            b1, b2 = ADAM_B1, ADAM_B2
            for m, g in zip(state.mu, grads):
                write(m, (1 - b1) * g + b1 * m)
            for v, g in zip(state.nu, grads):
                write(v, (1 - b2) * (g * g) + b2 * v)
            # optax's float32 bias corrections; a member whose gate is closed
            # reads its count's (discarded), count 1's at count 0
            bc1, bc2 = (_device_bias_correction(d, state.device_count) for d in (b1, b2))
            updates = [
                (m / per(bc1, m)) / (torch.sqrt(v / per(bc2, v)) + EPS)
                for m, v in zip(state.mu, state.nu)
            ]
            if self.name == "adamw":
                updates = [u + ADAMW_WEIGHT_DECAY * p for u, p in zip(updates, params)]
        elif self.name == "rmsprop":
            d = RMSPROP_DECAY
            for v, g in zip(state.nu, grads):
                write(v, (1 - d) * (g * g) + d * v)
            updates = [torch.rsqrt(v + EPS) * g for v, g in zip(state.nu, grads)]
        else:  # sgd
            updates = grads
        for p, u in zip(params, updates):
            write(p, p + -per(learning_rate, u) * u)


def make_optimizer(cfg) -> Optimizer:
    """Optimizer from config; the clip is in the chain iff
    ``cfg.max_grad_norm`` is set, as in the JAX package."""
    return Optimizer(cfg.optimizer, clip=cfg.max_grad_norm is not None)


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """Online and target networks, optimizer state, update counter."""

    online: torch.nn.Module
    target: torch.nn.Module
    opt_state: OptState
    updates: int  # a list of M for member-stacked networks


def init_train_state(network: torch.nn.Module, optimizer: Optimizer) -> TrainState:
    """Train state around an initialised ``network``; the target is a copy
    that takes no gradients.  A member-stacked network (``members``
    attribute) gets one count a member."""
    target = copy.deepcopy(network)
    target.requires_grad_(False)
    members = getattr(network, "members", None)
    return TrainState(
        online=network,
        target=target,
        opt_state=optimizer.init(list(network.parameters()), members),
        updates=0 if members is None else [0] * members,
    )


# ---------------------------------------------------------------------------
# ε-greedy policy + schedules
# ---------------------------------------------------------------------------

def epsilon_by_schedule(cfg, env_steps: float, episodes, hyper: Optional[HyperParams] = None):
    """Exploration rate from progress counters.  ``linear_step`` uses the
    host-side step count and returns a float; ``exp_episode`` uses the
    device-side episode count (a tensor), rescaled by ``num_envs`` to keep
    the reference's per-env decay rate, and returns a tensor.  With
    :class:`MemberHyperParams` (and ``episodes`` (M,)) both return an (M,)
    float32 tensor, each member's from its own values and episodes; there
    ``env_steps`` may be a host int or an int64 device tensor (a whole
    superstep's graph counts on the device), with equal bits: either is
    rounded to float32 and multiplied by the reciprocal of the decay steps,
    as a host number divided by a tensor is."""
    h = hyper if hyper is not None else HyperParams.from_config(cfg)
    if cfg.eps_schedule == "exp_episode":
        per_env_episodes = episodes.to(torch.float32) / cfg.num_envs
        eps = h.eps_start * h.eps_decay**per_env_episodes
        return torch.clamp(eps, min=h.eps_min)
    elif cfg.eps_schedule == "linear_step":
        if isinstance(h.eps_decay_steps, torch.Tensor):
            frac = torch.clamp(h.eps_decay_steps.reciprocal() * env_steps, 0.0, 1.0)
        else:
            frac = min(max(env_steps / h.eps_decay_steps, 0.0), 1.0)
        return h.eps_start + frac * (h.eps_min - h.eps_start)
    raise ValueError(f"unknown eps_schedule {cfg.eps_schedule!r}")


def epsilon_greedy(
    generator: Optional[torch.Generator],
    q_values: torch.Tensor,
    epsilon,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched ε-greedy with ONE uniform per env: ``u < ε`` explores, and
    then ``u / ε`` is again uniform, so ``floor(u / ε · A)`` is a uniform
    random action.  ``u`` may be injected; else it is drawn.

    A float ε is first put in a float32 tensor on ``u``'s device: CUDA
    divides by a Python float as a multiply by its float32 reciprocal, and
    by a tensor as a true division, so every caller (the eager frame, the
    graphed frame's device scalar, a population's (N,) rates) divides the
    same way."""
    n, num_actions = q_values.shape
    greedy = torch.argmax(q_values, dim=-1)
    if u is None:
        u = torch.rand((n,), generator=generator, device=q_values.device)
    if not isinstance(epsilon, torch.Tensor):
        epsilon = torch.full((), epsilon, dtype=torch.float32, device=u.device)
    explore = u < epsilon
    safe_eps = torch.clamp(epsilon, min=1e-9)
    random_actions = torch.clamp(
        (u / safe_eps * num_actions).to(torch.int32), max=num_actions - 1
    )
    return torch.where(explore, random_actions, greedy.to(torch.int32))


# ---------------------------------------------------------------------------
# Gradient update
# ---------------------------------------------------------------------------

def pmean_scale(world: int) -> float:
    """``lax.pmean``'s factor over ``world`` ranks: XLA multiplies the sum
    by the float32 reciprocal of the world size.  As a Python float it is
    that float32 exactly, and a float32 tensor multiplied by it gives the
    same bits on the CPU and on the card."""
    return float(np.float32(1) / np.float32(world))


def mean_of_sum(flat: torch.Tensor, world: int) -> torch.Tensor:
    """``flat``, a sum over ``world`` ranks, made their mean in place as
    ``lax.pmean`` makes it: times :func:`pmean_scale`.  A division by the
    world size differs from it in the last bit where the world size is not
    a power of two (a true division on the CPU; the card multiplies by the
    reciprocal of a Python divisor, but divides by a tensor)."""
    return flat.mul_(pmean_scale(world))


def all_reduce_sum(flat: torch.Tensor, group) -> None:
    """One ``all_reduce(SUM)`` of ``flat`` over the ranks of ``group``, in
    place: every rank gets the same buffer.  It runs eagerly, between the
    graphs of a graphed rank.  The profiler sees it as the span
    ``grad_all_reduce``."""
    with torch.profiler.record_function("grad_all_reduce"):
        dist.all_reduce(flat, group=group)


class UpdateStep:
    """``update(ts, batch, weights, hyper=None, mask=None, advance=True) ->
    (ts, loss, td)`` applies one gradient step to ``ts`` in place (see
    :func:`build_update_step`).

    With a process ``group`` (a rank of ``parallel/distributed.py``) it is
    three stages, which the eager rank calls in this order and the graphed
    rank (``algos/superstep.py::GraphedLearner``) runs as a CUDA graph, the
    collective and a second graph:

      * :meth:`local_gradients`: the loss, TD errors and gradients of this
        rank's sub-batch; the gradients and the loss written into one flat
        buffer (:meth:`flat`);
      * :meth:`all_reduce`: one ``all_reduce(SUM)`` of that buffer
        (:func:`all_reduce_sum`);
      * :meth:`apply_mean`: the sums made means as ``lax.pmean`` makes
        them (:func:`mean_of_sum`), split back into gradients, then the
        optimizer's clip and step and the Polyak step.

    So every rank clips and steps on the same gradients; the TD errors,
    which go back to the local priorities, stay local."""

    def __init__(self, optimizer: Optimizer, cfg, group=None):
        if cfg.ref_terminal_quirk and cfg.n_step != 1:
            raise ValueError("ref_terminal_quirk reproduces 1-step semantics; set n_step=1")
        if cfg.use_pallas:
            if cfg.loss != "huber":
                raise ValueError("use_pallas=True supports loss='huber' only")
            if cfg.ref_terminal_quirk:
                raise ValueError(
                    "use_pallas=True implements the FIXED terminal semantics; "
                    "disable ref_terminal_quirk"
                )
            from deep_q_learning_tpu_torch.ops.td_kernels import build_fused_loss_fn

            self.loss_fn = build_fused_loss_fn(double=cfg.double, huber_delta=cfg.huber_delta)
        else:
            self.loss_fn = build_loss_fn(
                double=cfg.double,
                loss=cfg.loss,
                huber_delta=cfg.huber_delta,
                ref_terminal_quirk=cfg.ref_terminal_quirk,
            )
        self.optimizer, self.cfg, self.group = optimizer, cfg, group
        self.world = 1 if group is None else dist.get_world_size(group)
        self._flats: dict = {}  # device: the flat buffer

    def flat(self, ts: TrainState) -> torch.Tensor:
        """The float32 buffer of a rank's collective: every gradient of
        ``ts.online``, flattened in parameter order, then the loss.  Made
        once for each device and kept, so that a graph can write into it."""
        params = list(ts.online.parameters())
        size = sum(p.numel() for p in params) + 1
        device = params[0].device
        if device not in self._flats or self._flats[device].numel() != size:
            self._flats[device] = torch.zeros((size,), device=device)
        return self._flats[device]

    def gradients(self, ts: TrainState, batch: LearnBatch, weights: torch.Tensor, mask=None):
        """``(loss, td, grads)`` of ``ts.online`` on ``batch``; members are
        independent, so the gradient of their summed losses is each
        member's own."""
        params = list(ts.online.parameters())
        loss, td = self.loss_fn(ts.online, ts.target, batch, weights)
        grads = torch.autograd.grad(loss if mask is None else loss.sum(), params)
        return loss.detach(), td, grads

    def local_gradients(self, ts: TrainState, batch: LearnBatch,
                        weights: torch.Tensor) -> torch.Tensor:
        """A rank's first stage: this rank's gradients and loss into
        :meth:`flat`; returns its TD errors."""
        loss, td, grads = self.gradients(ts, batch, weights)
        torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)], out=self.flat(ts))
        return td

    def all_reduce(self, ts: TrainState) -> None:
        """A rank's collective: :meth:`flat` summed over the ranks."""
        all_reduce_sum(self.flat(ts), self.group)

    def apply_mean(self, ts: TrainState, hyper, advance: bool = True) -> torch.Tensor:
        """A rank's last stage: the optimizer's step on the mean of the
        ranks' gradients; returns the mean loss (a view of :meth:`flat`,
        overwritten by the next update)."""
        flat = mean_of_sum(self.flat(ts), self.world)
        params = list(ts.online.parameters())
        parts = torch.split(flat, [p.numel() for p in params] + [1])
        self.apply(ts, [g.view_as(p) for g, p in zip(parts, params)], hyper, None, None, advance)
        return parts[-1].view(())

    def apply(self, ts: TrainState, grads, hyper, mask, gates, advance: bool) -> None:
        """The optimizer's clip and step, the Polyak step, and the host
        counters unless ``advance`` is False."""
        params = list(ts.online.parameters())
        self.optimizer.apply(grads, ts.opt_state, params, hyper.learning_rate,
                             hyper.max_grad_norm, mask, advance=advance and mask is None)
        if self.cfg.target_tau is not None:
            # Polyak soft target update every gradient step
            tau = hyper.target_tau
            write = _masked_writer(mask)
            with torch.no_grad():
                for t, p in zip(ts.target.parameters(), params):
                    write(t, (1.0 - _member_view(tau, t)) * t + _member_view(tau, t) * p)
        if advance:
            if mask is None:
                ts.updates += 1
            else:
                advance_members(ts, gates)

    def __call__(
        self,
        ts: TrainState,
        batch: LearnBatch,
        weights: torch.Tensor,
        hyper: Optional[HyperParams] = None,
        mask=None,
        advance: bool = True,
    ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
        """With ``mask`` (an (M,) bool tensor on the device, or M host
        bools): member-stacked ``ts``, batch (every leaf (M, B, ...)),
        ``weights`` (M, B) and :class:`MemberHyperParams`; only the members
        whose mask is True change.  Returns ``loss`` (M,) and ``td`` (M, B)
        for every member.  ``advance=False`` leaves the host counters
        (``ts.updates`` and the optimizer's count mirror) to the caller: the
        update then launches kernels only, and can be captured in a CUDA
        graph.  A mask given as a tensor needs ``advance=False``."""
        h = hyper if hyper is not None else HyperParams.from_config(self.cfg)
        mask, gates = _member_mask(mask, next(ts.online.parameters()).device)
        if mask is not None and advance and gates is None:
            raise ValueError("a device mask advances no host mirror: pass advance=False")
        if self.group is None:
            loss, td, grads = self.gradients(ts, batch, weights, mask)
            self.apply(ts, grads, h, mask, gates, advance)
            return ts, loss, td
        if mask is not None:
            raise ValueError("a population does not run under a process group")
        td = self.local_gradients(ts, batch, weights)
        self.all_reduce(ts)
        return ts, self.apply_mean(ts, h, advance).clone(), td


def build_update_step(optimizer: Optimizer, cfg, group=None) -> UpdateStep:
    """Returns ``update(ts, batch, weights, hyper) -> (ts, loss, td)``, which
    applies one gradient step to ``ts`` in place (:class:`UpdateStep`).
    ``cfg.use_pallas`` routes the TD and loss math through the CUDA kernel
    (``ops/td_kernels.py``).

    With a process ``group`` (the ranks of ``parallel/distributed.py``), the
    gradients and the loss are averaged over its ranks before the
    optimizer's clip, as ``lax.pmean`` averages them; the TD errors stay
    local.  Without one the update is a single learner's."""
    return UpdateStep(optimizer, cfg, group)


def advance_members(ts: TrainState, gates: Sequence[bool]) -> None:
    """The host mirrors of one member update under ``gates``: each open
    member's update count and Adam count advance by one."""
    ts.updates = [u + bool(k) for u, k in zip(ts.updates, gates)]
    ts.opt_state.count = [c + bool(k) for c, k in zip(ts.opt_state.count, gates)]


@torch.no_grad()
def sync_target(ts: TrainState, do_sync=True) -> TrainState:
    """Hard target copy.  ``do_sync`` may be a device bool tensor, so the
    copy can be conditional without reading it back to the host.  For
    member-stacked networks it is one decision a member: an (M,) bool
    tensor, or a sequence of M host bools."""
    if isinstance(do_sync, (list, tuple)):
        do_sync = _member_mask(do_sync, next(ts.online.parameters()).device)[0]
    for t, p in zip(ts.target.parameters(), ts.online.parameters()):
        if isinstance(do_sync, torch.Tensor):
            t.copy_(torch.where(_member_view(do_sync, t), p, t))
        elif do_sync:
            t.copy_(p)
    return ts

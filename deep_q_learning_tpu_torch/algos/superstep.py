"""The actor-learner superstep (``deep_q_learning_tpu/algos/superstep.py``).

One call runs ``cfg.steps_per_superstep`` vector steps, each: ε-greedy
actor forward → vector env step with auto-reset → replay write → episode
accounting → (on training frames) prioritized n-step sample, learner
update, priority update → target sync.

The JAX package jits the whole superstep into one XLA program
(``deep_q_learning_tpu/train.py:123``): a ``lax.fori_loop`` over frames
whose train and sync gates are ``lax.cond``s on device counters.  Here the
train gates are plain Python decisions on counters the host knows without
reading the device (``env_step``, the replay's fill): before a superstep
the host lists, frame by frame, whether an update runs there (the
superstep's *pattern*; a population's, which members' gates are open).
The sample runs only on frames that train, and nothing in a superstep
reads a device value back.  Metrics are read once, at the end of the
superstep.

A single learner runs as CUDA graphs on the card (:class:`GraphedLearner`,
the port's counterpart of that ``jit``) wherever its env injects its draws
(the lander and the classic envs), with either replay.  A steady
superstep is ONE graph: the reset pool, then every frame (the actor's
uniforms, the env step's draws, the actor's forward and ε-greedy, the
vector step with auto-reset, the replay write at the device cursor, the
episode accounting), on the frames the pattern says each update's two
sampler uniforms and the learner update (the sample, the forward, the TD
kernels and the backward, the clip, Adam, the Polyak step and, for PER,
the priority write), ``updates_per_step`` times, and the hard target sync.
The draws are taken inside the graph from the runner's generator,
registered with the graph, in the eager order, so that a replay is the
eager superstep bit for bit.  The sync is decided on the device, as the
JAX package's ``lax.cond`` decides it: every ``target_sync_every`` frames
of a device frame counter (``RunnerState.device_env_step``, mirrored by
``env_step``), or on the episode count; so the sync frames stay out of
the pattern.  ε under ``linear_step`` is the host's float for each frame,
written into a static table of the superstep's frames by one copy.  Such a
graph is captured the second time its pattern is seen (the preset's
warm-up, its boundary superstep and its steady one make three at most for
a ``steps_per_superstep`` that ``train_every`` divides) and kept in a small
cache; a superstep whose pattern is new runs frame by frame, as does
every superstep of a rank of a process group: the draws first, in the
eager order, into static buffers; then one graph of the frame and, on a
frame that trains, one graph of the learner update, replayed
``updates_per_step`` times; the pool as a graph of ``VectorEnv``'s and
the hard target sync eagerly between the graphs.  Every piece of state
the graphs touch is updated in place; the counters they advance live on
the device, with host mirrors (``envs/graphed.py::device_mirror``),
which the host advances by the superstep's frames and updates.  On the
CPU the same functions run directly on the same buffers.  A rank splits
its update in two at the gradient all-reduce, which runs eagerly between
graphs L1 and L2.  ``graphed_learner=False`` runs the frame eagerly, the
vector step still as ``VectorEnv``'s graph (``envs/base.py``,
``envs/graphed.py``); its outputs (``r.obs``, ``r.env_states``, the
transition) are overwritten by the next frame's step, and each is
consumed before it: the replay write copies the transition, and the next
step copies the observation and the states into its inputs.

:func:`build_population_superstep` runs M learners in lockstep, where the
JAX package ``jax.vmap``s this superstep: one vector env of M·N envs
(member ``m``'s at rows ``m·N``), member-stacked networks, one replay of
M members, and per-member hyperparameters.  Its loop shares this module's
per-frame helpers.  Each member's train gate is a host decision as here,
its sync a device one in the superstep's graph; a member whose gate is
closed is left as it was (a device ``mask`` in ``algos/dqn.py`` and the
replays), as a closed ``lax.cond`` under ``vmap`` is a select.  It runs as
CUDA graphs too (:class:`GraphedPopulation`), on the same envs and
replays: a steady superstep one graph for every member, its gates an
(F, M) mask table made once for its pattern; frame by frame the same
frame graph for every member's envs, and graph L for every member, the
host writing the gates into a static mask before its replays; its Adam
counts and replay counters live on the device.  The members draw their
random numbers from one generator, in lockstep, so each member's draws
depend on which frames any member trains, not only its own.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import math
from typing import Any, Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deep_q_learning_tpu_torch.algos.dqn import (
    HyperParams,
    MemberHyperParams,
    TrainState,
    advance_members,
    build_update_step,
    epsilon_by_schedule,
    epsilon_greedy,
    init_train_state,
    sync_target,
)
from deep_q_learning_tpu_torch.envs.base import Transition, VectorEnv
from deep_q_learning_tpu_torch.envs.graphed import (
    GraphedStep,
    copy_into,
    device_mirror,
    tensors_of,
    tree_map,
)


@dataclasses.dataclass
class RunnerState:
    """Everything the training loop owns.  Host counters are ints; the
    others live on the device.  A population's runner has a leading member
    axis M on the episode counters and the window, (M, N) running returns
    and lengths, and :class:`MemberHyperParams`."""

    train: TrainState
    hyper: HyperParams
    env_states: Any  # batched env state, leaves (N, ...)
    obs: torch.Tensor  # (N, D) current observations
    replay: Any  # ReplayState | PrioritizedReplayState
    generator: torch.Generator  # all draws after init (device generator)
    # vector steps taken (aggregate steps = env_step * N), mirroring the
    # device counter that a superstep's graph decides its syncs on
    env_step: int = device_mirror("device_env_step")
    device_env_step: torch.Tensor  # () int64
    episodes: torch.Tensor  # () int64 completed episodes
    last_sync_episodes: torch.Tensor  # () int64 episode count at the last hard sync
    ep_return: torch.Tensor  # (N,) f32 running return per env
    ep_length: torch.Tensor  # (N,) int32 running length per env
    return_window: torch.Tensor  # (W,) f32 ring of completed returns
    window_cursor: torch.Tensor  # () int64
    window_filled: torch.Tensor  # () int64


@dataclasses.dataclass
class SuperstepMetrics:
    """Read back once per superstep, as Python numbers; a population's as
    numpy arrays (M,), all but ``env_steps``."""

    env_steps: int  # VECTOR steps so far (aggregate = env_steps * num_envs)
    episodes: int
    episodes_delta: int  # completed during this superstep
    return_sum_delta: float  # sum of returns completed this superstep
    loss_sum: float
    loss_count: int  # learner updates this superstep
    window_mean: float  # mean of the last W completed returns (-inf if none)
    epsilon: float
    solved: bool  # window full and mean >= threshold


# How one rank's metrics combine over the ranks of a process group, as the
# JAX package's ``_reduce_metrics`` does over the mesh: the lockstep
# counters by max, the episode, return and loss tallies by sum, the window
# means by their mean, and ``solved`` by min (only when every rank's window
# clears the threshold).  The order is the packed vector's.
METRIC_REDUCTIONS = {
    "env_steps": max, "loss_count": sum, "episodes": sum, "episodes_delta": sum,
    "return_sum_delta": sum, "loss_sum": sum, "window_mean": lambda xs: sum(xs) / len(xs),
    "epsilon": max, "solved": min,
}


def reduce_metrics(local: torch.Tensor, group) -> List[float]:
    """Every rank's packed metrics (float64, in the order of
    :data:`METRIC_REDUCTIONS`) combined over the ranks of ``group``.  One
    collective: each rank puts its values in its own row of a (world,
    fields) buffer of zeros and one ``all_reduce(SUM)`` gathers the rows
    (adding zeros is exact); each rank then reduces the rows on the host in
    rank order, so every rank gets the same numbers."""
    rows = local.new_zeros((dist.get_world_size(group), local.numel()))
    rows[dist.get_rank(group)] = local
    dist.all_reduce(rows, group=group)
    return [reduce(col) for reduce, col in zip(METRIC_REDUCTIONS.values(), zip(*rows.tolist()))]


def _scatter_completed_returns(
    window: torch.Tensor,
    cursor: torch.Tensor,
    filled: torch.Tensor,
    done: torch.Tensor,
    returns: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Write the returns of the envs that finished this step into the ring
    window: each finisher's slot is its rank among finishers (env order)
    past the cursor.  Only the last ``W`` finishers can survive the ring, and
    their slots are unique, so they are written directly; the others go to
    a spare slot past the end that is then dropped.  No host sync.  With a
    leading member axis (``window`` (M, W), ``done`` (M, N)), each member's
    window from its own envs, with a spare slot a member."""
    w = window.shape[-1]
    done_i = done.to(torch.int64)
    rank = torch.cumsum(done_i, dim=-1) - 1  # rank among finished, in env order
    num_done = done_i.sum(dim=-1)
    sel = done & (rank >= (num_done - w)[..., None])
    slot = torch.where(sel, (cursor[..., None] + rank) % w, w)
    padded = torch.cat([window, window.new_zeros(window.shape[:-1] + (1,))], dim=-1)
    padded.scatter_(-1, slot, returns)
    return padded[..., :w], (cursor + num_done) % w, torch.clamp(filled + num_done, max=w)


def _account(r: RunnerState, tr: Transition):
    """The episode accounting of one vector step, in place.  Returns the
    episodes that ended and the sum of their returns, per member for a
    population."""
    done = (tr.terminated | tr.truncated).view(r.ep_return.shape)
    ep_return = r.ep_return + tr.reward.view(r.ep_return.shape)
    window, cursor, filled = _scatter_completed_returns(
        r.return_window, r.window_cursor, r.window_filled, done, ep_return
    )
    r.return_window.copy_(window)
    r.window_cursor.copy_(cursor)
    r.window_filled.copy_(filled)
    num_done = done.sum(dim=-1)
    r.episodes.add_(num_done)
    r.ep_return.copy_(torch.where(done, 0.0, ep_return))
    r.ep_length.copy_(torch.where(done, 0, r.ep_length + 1))
    return num_done, torch.where(done, ep_return, 0.0).sum(dim=-1)


def _act_and_step(r: RunnerState, venv, env_params, replay, q_values, eps, fresh):
    """One vector step of ``r``: ε-greedy actions from ``q_values`` (one row
    an env), the env step with auto-reset, the replay write, and the episode
    accounting."""
    actions = epsilon_greedy(r.generator, q_values, eps)
    r.obs, r.env_states, tr = venv.step(
        r.generator, r.env_states, actions, env_params, prev_obs=r.obs, fresh=fresh
    )
    replay.add(r.replay, tr)
    return _account(r, tr)


def _window_mean(r: RunnerState) -> torch.Tensor:
    """Mean of the returns in the window (-inf while it is empty)."""
    return torch.where(
        r.window_filled > 0,
        r.return_window.sum(dim=-1) / torch.clamp(r.window_filled, min=1),
        -math.inf,
    )


def _seeds(seed: int, n: int):
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n)]


def _read_metrics(r: RunnerState, loss_sum, loss_count: int, ep_delta, ret_delta, eps, cfg,
                  group) -> SuperstepMetrics:
    """The superstep's metrics, in its one device->host read; with a
    process ``group``, combined over its ranks (:func:`reduce_metrics`)."""
    threshold = math.inf if cfg.solve_threshold is None else cfg.solve_threshold
    device = r.episodes.device
    mean = _window_mean(r).to(torch.float64)
    tallies = torch.stack([
        r.episodes.to(torch.float64),
        ep_delta.to(torch.float64),
        ret_delta.to(torch.float64),
        loss_sum.to(torch.float64),
        mean,
        torch.as_tensor(eps, dtype=torch.float64, device=device),
        ((r.window_filled >= cfg.return_window) & (mean >= threshold)).to(torch.float64),
    ])
    if group is None:
        env_steps, count = r.env_step, loss_count
        episodes, ep_d, ret_d, loss_s, mean_v, eps_v, solved = tallies.tolist()
    else:
        counts = torch.tensor([r.env_step, loss_count], dtype=torch.float64).to(device)
        env_steps, count, episodes, ep_d, ret_d, loss_s, mean_v, eps_v, solved = reduce_metrics(
            torch.cat([counts, tallies]), group)
    return SuperstepMetrics(
        env_steps=int(env_steps),
        episodes=int(episodes),
        episodes_delta=int(ep_d),
        return_sum_delta=ret_d,
        loss_sum=loss_s,
        loss_count=int(count),
        window_mean=mean_v,
        epsilon=eps_v,
        solved=bool(solved),
    )


class _LearnerWork:
    """What the graphed learner's graphs run, and the static buffers they
    read and add into (:class:`GraphedLearner`).  It holds no graph, so the
    graphs' functions (its methods) make no reference cycle that would keep
    their memory until the garbage collector's next full pass.  With
    ``members`` M (:class:`GraphedPopulation`) the buffers have a member
    axis, and the gate ``mask`` (M,) says which members an update changes.
    A rank of ``world`` ranks splits the update at its collective
    (:meth:`learn_local`, :meth:`learn_mean`)."""

    def __init__(self, venv, env_params, replay, update, sync, cfg, device, members=None,
                 world=1):
        self.venv, self.env_params, self.replay, self.update = venv, env_params, replay, update
        self.sync, self.cfg, self.members = sync, cfg, members
        self.envs = venv.num_envs // (members or 1)  # a member's
        self.global_envs = self.envs * world  # the warm-up gate and linear_step ε count these
        m = () if members is None else (members,)
        self.u_act = torch.zeros((venv.num_envs,), device=device)
        self.eps = torch.zeros(m, device=device)
        # a single learner's linear_step ε for each frame of a superstep's
        # graph, written by the host before its replay
        self.eps_table = torch.zeros((cfg.steps_per_superstep,), device=device)
        # the sampler's uniforms, in the dtypes its eager draw takes
        self.u_env, self.u_slot = (torch.zeros(m + (cfg.batch_size,), dtype=dtype, device=device)
                                   for dtype in replay.uniform_dtypes)
        self.mask = None if members is None else torch.zeros(m, dtype=torch.bool, device=device)
        self.loss_sum = torch.zeros(m, device=device)
        self.ep_delta = torch.zeros(m, dtype=torch.int64, device=device)
        self.ret_delta = torch.zeros(m, device=device)
        self.draws = None  # the env step's, a clone of the first frame's at first
        self.runner = self.fresh = None
        # what a superstep's capture bakes in: each frame's gates (None where
        # no update runs) and a population's (F, M) table of them
        self.pattern = self.masks = None

    def statics(self) -> List[torch.Tensor]:
        return tensors_of([self.u_act, self.eps, self.eps_table, self.u_env, self.u_slot,
                           self.mask, self.loss_sum, self.ep_delta, self.ret_delta])

    def draw_sample(self, generator: torch.Generator) -> None:
        """An update's two sampler uniforms, as the eager sample draws them."""
        for u in (self.u_env, self.u_slot):
            torch.rand(u.shape, generator=generator, dtype=u.dtype, device=u.device, out=u)

    def frame(self, *_bound) -> None:
        """One vector step of ``self.runner`` on the static buffers, in place."""
        self._frame(self.eps, self.draws, self.fresh)

    def _frame(self, eps, draws, fresh) -> None:
        """One vector step on the actor's uniforms ``u_act``, ε ``eps``
        (computed here under ``exp_episode``), the env step's ``draws`` and
        the reset pool ``fresh``, in place; the device frame counter
        advanced."""
        r, cfg = self.runner, self.cfg
        with torch.no_grad():
            if cfg.eps_schedule != "linear_step":
                eps = self.eps.copy_(epsilon_by_schedule(cfg, 0, r.episodes, r.hyper))
            if self.members is None:
                q_values = r.train.online(r.obs)
            else:  # member m's envs at rows m·N
                obs = r.obs.view(self.members, self.envs, -1)
                q_values = r.train.online(obs).flatten(0, 1)
                eps = eps.repeat_interleave(self.envs)
            actions = epsilon_greedy(None, q_values, eps, u=self.u_act)
            obs, states, tr = self.venv._step(
                None, r.env_states, actions, self.env_params, r.obs, fresh, *draws)
            self.replay.write(r.replay, tr)
            num_done, ret_done = _account(r, tr)
            self.ep_delta.add_(num_done)
            self.ret_delta.add_(ret_done)
            r.obs.copy_(obs)
            copy_into(r.env_states, states)
            r.device_env_step.add_(1)

    def superstep(self, *_bound) -> None:
        """A whole superstep of ``self.runner`` on the gates of
        ``self.pattern``, in place: what :class:`GraphedLearner` runs frame
        by frame, the random numbers taken from the runner's generator in
        the same order (the pool's, then each frame's actor uniforms, step
        draws and, without a pool, reset draws, then each update's two
        uniforms), and the hard target sync decided on the device."""
        r, cfg = self.runner, self.cfg
        env, n, g = self.venv.env, self.venv.num_envs, r.generator
        for total in (self.loss_sum, self.ep_delta, self.ret_delta):
            total.zero_()
        fresh = None
        if not env.batch_reset_cheap:
            fresh = env.reset_env(None, n, self.env_params, env.reset_draws(g, n))
        for f, gates in enumerate(self.pattern):
            eps = self.eps
            if cfg.eps_schedule == "linear_step":
                eps = self.eps_table[f] if self.members is None else self.eps.copy_(
                    epsilon_by_schedule(cfg, r.device_env_step * self.global_envs, r.episodes,
                                        r.hyper))
            torch.rand(self.u_act.shape, generator=g, device=self.u_act.device, out=self.u_act)
            draws = [env.step_draws(g, n)]
            if fresh is None:
                draws.append(env.reset_draws(g, n))
            self._frame(eps, draws, fresh)
            if gates is not None:
                if self.mask is not None:
                    self.mask.copy_(self.masks[f])
                for _ in range(cfg.updates_per_step):
                    self.draw_sample(g)
                    self.learn()
            self.sync(r, on_device=True)

    def learn(self, *_bound) -> None:
        """One learner update of ``self.runner`` on the static uniforms, in
        place; its loss added into ``loss_sum`` (a closed gate's as 0)."""
        r, h = self.runner, self.runner.hyper
        batch, info, weights = self.replay.sample_with_info(
            r.replay, None, self.cfg.batch_size, gamma=h.gamma, beta=h.per_beta,
            uniforms=(self.u_env, self.u_slot))
        mask = () if self.mask is None else (self.mask,)  # a population's gates
        _, loss, td = self.update(r.train, batch, weights, h, *mask, advance=False)
        self.replay.update_priorities(r.replay, info, td, *mask)
        self.loss_sum.add_(loss if self.mask is None else torch.where(self.mask, loss, 0.0))

    def learn_local(self, *_bound) -> None:
        """A rank's update up to its collective (graph L1): the sample on
        the static uniforms, this rank's gradients and loss into the update's
        flat buffer (``algos/dqn.py::UpdateStep``), and the local priority
        write."""
        r, h = self.runner, self.runner.hyper
        batch, info, weights = self.replay.sample_with_info(
            r.replay, None, self.cfg.batch_size, gamma=h.gamma, beta=h.per_beta,
            uniforms=(self.u_env, self.u_slot))
        td = self.update.local_gradients(r.train, batch, weights)
        self.replay.update_priorities(r.replay, info, td)

    def learn_mean(self, *_bound) -> None:
        """A rank's update after its collective (graph L2): the optimizer's
        step on the ranks' mean gradients, the mean loss added into
        ``loss_sum``."""
        r = self.runner
        self.loss_sum.add_(self.update.apply_mean(r.train, r.hyper, advance=False))


class GraphedLearner:
    """The superstep of a single learner as CUDA graphs (module docstring):
    ``graphed(runner) -> (runner, SuperstepMetrics)``.

    Before each superstep the host lists its :meth:`pattern`.  A pattern
    seen before (with the same baked hyperparameters and runner) replays
    the superstep's own graph, an in-place ``GraphedStep`` of
    ``_LearnerWork.superstep`` with the runner's generator registered,
    captured at that second sighting without an eager warm-up (its
    frames have run as graphs of their own).  At most ``max_graphs`` such
    graphs are held; a pattern that repeats once they are all taken runs
    frame by frame (``max_graphs = 0``: every superstep does).
    ``runs`` counts the supersteps that ran as one replay (``"whole"``) and
    frame by frame (``"frames"``).

    Frame by frame, static buffers hold what the host writes before a graph
    runs: the actor's uniforms and ε (written each frame under
    ``linear_step``, computed in the frame graph under ``exp_episode``),
    the env step's draws, the sampler's two uniforms; and what the graphs
    add up over a superstep: the loss, the episodes ended and their
    returns.  :attr:`frame` and :attr:`learn` are in-place
    ``GraphedStep``s bound to the runner's tensors: a restored runner (new
    tensors) starts each over with an eager call, and new hyperparameters
    (baked into a capture as kernel arguments) make new ones, and drop the
    superstep graphs.

    A rank of a process ``group`` always runs frame by frame: it replays
    :attr:`learn` (graph L1: the sample, the local gradients into the
    update's flat buffer, the priority write), then runs the collective
    eagerly, then replays :attr:`learn_mean` (graph L2: the mean, the
    clip, Adam and Polyak), the three stages of ``algos/dqn.py::
    UpdateStep`` that the eager rank calls in the same order.  Its frame
    graph is a single learner's; its warm-up gate and ``linear_step`` ε
    count the envs of every rank, and its metrics come back combined over
    the ranks."""

    members = None
    max_graphs = 4  # whole-superstep graphs held; once full, new patterns run frame by frame
    max_seen = 64  # patterns remembered as seen once, the oldest forgotten first

    def __init__(self, venv, env_params, replay, update, cfg, device, sync, gates, group=None):
        world = 1 if group is None else dist.get_world_size(group)
        self.work = _LearnerWork(venv, env_params, replay, update, sync, cfg, device,
                                 self.members, world)
        self.cfg, self.sync, self.group = cfg, sync, group
        self.gates = gates  # gates(hyper, env_step, filled) -> a frame's gates, or None
        self.hyper = self.frame = self.learn = self.learn_mean = None
        self.supersteps = {}  # (cadence, pattern) -> (graph, masks)
        self.seen = collections.OrderedDict()  # (cadence, pattern) seen once
        self.bound_to = None  # the generator and tensors the superstep graphs are bound to
        self.runs = collections.Counter()

    def _baked(self, hyper) -> Any:
        """What a capture bakes in of ``hyper``: a single learner's floats."""
        return dataclasses.astuple(hyper)

    def _cadence(self, hyper) -> Any:
        """What a superstep's capture bakes in of ``hyper`` beside its
        pattern and :meth:`_baked` (whose change drops every graph): for a
        single learner, nothing."""
        return None

    def pattern(self, r: RunnerState) -> tuple:
        """The gates of each frame of ``r``'s next superstep, from the host
        counters as its frames advance them."""
        adds, capacity = r.replay.total_adds, r.replay.capacity_per_env
        return tuple(self.gates(r.hyper, r.env_step + f, min(adds + f, capacity))
                     for f in range(1, self.cfg.steps_per_superstep + 1))

    def key(self, r: RunnerState) -> tuple:
        """What ``r``'s next superstep's graph is cached by: the cadence its
        capture bakes in and its pattern."""
        return self._cadence(r.hyper), self.pattern(r)

    def _open(self, gates) -> None:
        """Before a frame's updates: a population writes its gates."""

    def _updated(self, r: RunnerState, gates) -> None:
        """The host mirrors of one update under ``gates``."""
        r.train.updates += 1
        r.train.opt_state.count += 1

    def _metrics(self, r: RunnerState, loss_count) -> SuperstepMetrics:
        w = self.work
        eps = epsilon_by_schedule(self.cfg, r.env_step * w.global_envs, r.episodes, r.hyper)
        return _read_metrics(r, w.loss_sum, int(loss_count), w.ep_delta, w.ret_delta, eps,
                             self.cfg, self.group)

    def __call__(self, r: RunnerState) -> Tuple[RunnerState, SuperstepMetrics]:
        w, cfg = self.work, self.cfg
        baked = self._baked(r.hyper)
        if self.frame is None or baked != self.hyper:
            name = f"the {cfg.env_id} {'population' if self.members else 'learner'}'s"
            self.frame = GraphedStep(w.frame, f"{name} frame", in_place=True)
            if self.group is None:
                self.learn = GraphedStep(w.learn, f"{name} update", in_place=True)
            else:
                self.learn = GraphedStep(w.learn_local, f"{name} local gradients", in_place=True)
                self.learn_mean = GraphedStep(w.learn_mean, f"{name} step on the mean",
                                              in_place=True)
            self.hyper = baked
            self.supersteps.clear()
            self.seen.clear()
        w.runner = r
        key = self.key(r)
        pattern = key[1]
        whole = self._whole(r, key)
        self.runs["frames" if whole is None else "whole"] += 1
        if whole is None:
            self._frames(r, pattern)
        else:
            self.replay_superstep(r, pattern, *whole)
        loss_count = np.zeros(() if self.members is None else (self.members,), dtype=np.int64)
        for gates in pattern:
            if gates is not None:
                loss_count = loss_count + np.asarray(gates) * cfg.updates_per_step
        return r, self._metrics(r, loss_count)

    def _bound(self, r: RunnerState) -> List[torch.Tensor]:
        """Every tensor a superstep's graph reads or writes."""
        return tensors_of((r, self.work.statics()))

    def _whole(self, r: RunnerState, key: tuple):
        """``(graph, masks)`` of the superstep graph for ``key``, or None
        where this superstep runs frame by frame: a rank's, and one whose
        pattern this runner has not run before."""
        if self.group is not None or self.max_graphs == 0:
            return None
        bound_to = (id(r.generator),) + tuple(t.data_ptr() for t in self._bound(r))
        if bound_to != self.bound_to:  # another runner: its graphs start over
            self.supersteps.clear()
            self.seen.clear()
            self.bound_to = bound_to
        if key in self.supersteps:
            return self.supersteps[key]
        if key not in self.seen or len(self.supersteps) >= self.max_graphs:
            self.seen[key] = None
            self.seen.move_to_end(key)
            if len(self.seen) > self.max_seen:  # the oldest forgotten
                self.seen.popitem(last=False)
            return None
        del self.seen[key]
        masks = None
        if self.members is not None:
            masks = torch.tensor([gates or (False,) * self.members for gates in key[1]],
                                 dtype=torch.bool, device=self.work.mask.device)
        name = f"the {self.cfg.env_id} {'population' if self.members else 'learner'}'s superstep"
        graph = GraphedStep(self.work.superstep, name, in_place=True, generator=r.generator,
                            warm_up=False)
        self.supersteps[key] = graph, masks
        return graph, masks

    def replay_superstep(self, r: RunnerState, pattern: tuple, graph: GraphedStep,
                         masks) -> None:
        """The superstep as one replay of ``graph`` (its capture first, at
        its first call), then the host mirrors advanced by its frames and
        updates."""
        w, cfg = self.work, self.cfg
        frames = cfg.steps_per_superstep
        if cfg.eps_schedule == "linear_step" and self.members is None:
            eps = [epsilon_by_schedule(cfg, (r.env_step + f) * w.global_envs, r.episodes, r.hyper)
                   for f in range(frames)]
            w.eps_table.copy_(torch.tensor(eps, dtype=torch.float32))
        w.pattern, w.masks = pattern, masks
        graph((self._bound(r), masks))
        r.env_step += frames
        w.replay.advance(r.replay, frames)
        for gates in pattern:
            if gates is not None:
                for _ in range(cfg.updates_per_step):
                    self._updated(r, gates)

    def _frames(self, r: RunnerState, pattern: tuple) -> None:
        """The superstep frame by frame: the frame's graph, and on the
        frames that train, graph L (a rank's L1, the collective and L2)."""
        w, cfg = self.work, self.cfg
        venv, env, replay = w.venv, w.venv.env, w.replay
        w.fresh = None if env.batch_reset_cheap else venv.fresh_pool(r.generator, w.env_params)
        for total in (w.loss_sum, w.ep_delta, w.ret_delta):
            total.zero_()
        statics = w.statics()
        if self.group is not None:
            statics.append(w.update.flat(r.train))
        n = venv.num_envs
        for gates in pattern:
            # the draws in the eager frame's order: the actor's, the step's,
            # the resets' (without a pool), then each update's two
            if cfg.eps_schedule == "linear_step":
                eps = epsilon_by_schedule(cfg, r.env_step * w.global_envs, r.episodes, r.hyper)
                if isinstance(eps, torch.Tensor):  # a population's (M,)
                    w.eps.copy_(eps)
                else:
                    w.eps.fill_(eps)
            torch.rand((n,), generator=r.generator, device=w.u_act.device, out=w.u_act)
            draws = [env.step_draws(r.generator, n)]
            if w.fresh is None:
                draws.append(env.reset_draws(r.generator, n))
            if w.draws is None:
                w.draws = tree_map(torch.clone, draws)
            else:
                copy_into(w.draws, draws)
            self.frame(tensors_of((r.train.online, r.hyper, r.obs, r.env_states, r.replay,
                                   r.device_env_step, r.episodes, r.ep_return, r.ep_length,
                                   r.return_window, r.window_cursor, r.window_filled, w.fresh,
                                   w.draws, statics)))
            replay.advance(r.replay)
            r.env_step += 1
            if gates is not None:
                self._open(gates)
                for _ in range(cfg.updates_per_step):
                    w.draw_sample(r.generator)
                    bound = tensors_of((r.train, r.hyper, r.replay, statics))
                    self.learn(bound)
                    if self.group is not None:
                        w.update.all_reduce(r.train)
                        self.learn_mean(bound)
                    self._updated(r, gates)
            self.sync(r)


class GraphedPopulation(GraphedLearner):
    """The superstep of a population of ``members`` learners as CUDA
    graphs, as :class:`GraphedLearner` runs one learner's: a steady
    superstep one graph for every member, its pattern's gates an (F, M)
    mask table on the device, made when its graph is; frame by frame, the
    frame graph steps every member's envs, and graph L updates the members
    whose train gate is open, the host writing the gates into the static
    ``mask`` (M,) before its replays; a frame on which no gate is open
    replays no graph L, as the eager loop runs no update.  The float
    hyperparameters are (M,) tensors the graphs are bound to, as to the
    runner's: ``set_population_hyper`` makes new ones, and the graphs start
    over with an eager call (a superstep graph with its next sighting)."""

    def __init__(self, venv, env_params, replay, update, cfg, device, sync, gates, members,
                 as_tensor):
        self.members = members
        super().__init__(venv, env_params, replay, update, cfg, device, sync, gates)
        self.as_tensor = as_tensor  # host values -> a device tensor, made once each

    def _baked(self, hyper) -> Any:
        return None  # the floats are tensors, the cadences host ints

    def _cadence(self, hyper) -> Any:
        """The members' sync cadences, which the superstep's graph reads as
        device tensors: made here, before a capture."""
        cadence = (hyper.target_sync_every, hyper.target_replace_episodes)
        for values in cadence:
            self.as_tensor(values)
        return cadence

    def _open(self, gates) -> None:
        self.work.mask.copy_(self.as_tensor(gates, torch.bool))

    def _updated(self, r: RunnerState, gates) -> None:
        advance_members(r.train, gates)

    def _metrics(self, r: RunnerState, loss_count) -> SuperstepMetrics:
        w = self.work
        eps = epsilon_by_schedule(self.cfg, r.env_step * w.envs, r.episodes, r.hyper)
        return _read_member_metrics(r, w.loss_sum, loss_count, w.ep_delta, w.ret_delta, eps,
                                    self.cfg)


def build_superstep(
    venv: VectorEnv,
    env_params: Any,
    network: torch.nn.Module,
    optimizer,
    replay,
    cfg,
    device,
    group=None,
    graphed_learner: bool = True,
) -> Tuple[Callable, Callable]:
    """Build ``(init_runner, superstep)``.

    ``init_runner(seed, shard=0) -> RunnerState`` initialises a copy of
    ``network`` (flax init from a CPU generator, so the weights for a seed
    are the same on every device and every shard) and everything else on
    ``device``, from a generator of its own for each ``shard``.
    ``superstep(runner) -> (runner, SuperstepMetrics)`` advances ``runner``
    in place.

    With a process ``group`` this is the body of one rank of
    ``parallel/distributed.py``: ``venv`` holds the rank's envs and ``cfg``
    its local config.  Gradients are averaged over the ranks in the update;
    the warm-up gate and ``linear_step`` ε count global env steps (local
    steps times ``num_envs`` times the world size), as the JAX package's
    ``num_shards`` makes them; ``episodes``-mode target syncs decide on the
    episode count summed over the ranks; and the metrics come back combined
    over the ranks.  ``exp_episode`` ε stays per rank: the local episode
    count over the local ``num_envs``, as the JAX shard body computes it.

    The superstep is a :class:`GraphedLearner` where ``graphed_learner`` is
    set and ``venv`` graphs its step (an env that injects its draws: the
    lander and the classic envs), under a process group too; else each
    frame runs eagerly, with the same results: the eager sample draws the
    same two uniforms, in the same shapes, dtypes and order, that the
    graphed learner draws before graph L, and a rank's eager update calls
    the three stages that a graphed rank runs as graph L1, the collective
    and graph L2.  The collective itself always runs eagerly (gloo's cannot
    be captured), between the graphs."""
    device = torch.device(device)
    update = build_update_step(optimizer, cfg, group)
    num_envs = venv.num_envs
    global_envs = num_envs * (1 if group is None else dist.get_world_size(group))

    def init_runner(seed: int, shard: int = 0) -> RunnerState:
        seeds = _seeds(seed, 2 + shard)
        net_seed, run_seed = seeds[0], seeds[1 + shard]
        online = copy.deepcopy(network).to("cpu")
        online.reset_parameters(torch.Generator().manual_seed(net_seed))
        train = init_train_state(online.to(device), optimizer)
        generator = torch.Generator(device=device).manual_seed(run_seed)
        obs, env_states = venv.reset(generator, env_params)
        example = Transition(
            obs=obs,
            action=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            reward=torch.zeros((num_envs,), device=device),
            next_obs=obs,
            terminated=torch.zeros((num_envs,), dtype=torch.bool, device=device),
            truncated=torch.zeros((num_envs,), dtype=torch.bool, device=device),
        )
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return RunnerState(
            train=train,
            hyper=HyperParams.from_config(cfg),
            env_states=env_states,
            obs=obs,
            replay=replay.init(example),
            generator=generator,
            env_step=0,
            device_env_step=torch.zeros((), dtype=torch.int64, device=device),
            episodes=zero.clone(),
            last_sync_episodes=zero.clone(),
            ep_return=torch.zeros((num_envs,), device=device),
            ep_length=torch.zeros((num_envs,), dtype=torch.int32, device=device),
            return_window=torch.zeros((cfg.return_window,), device=device),
            window_cursor=zero.clone(),
            window_filled=zero.clone(),
        )

    def train_gate(h, env_step: int, filled: int):
        """The cadence and the warm-up gate (in stored transitions) after
        vector step ``env_step`` with ``filled`` slots a row stored: True
        where an update runs, else None."""
        if env_step % h.train_every == 0 and filled * global_envs >= h.training_start:
            return True
        return None

    def _maybe_train(r: RunnerState, loss_sum: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """``cfg.updates_per_step`` updates where ``train_gate`` opens, each
        loss added to ``loss_sum``; returns the sum and the count of
        updates."""
        h = r.hyper
        if train_gate(h, r.env_step, r.replay.filled) is None:
            return loss_sum, 0
        for _ in range(cfg.updates_per_step):
            batch, info, weights = replay.sample_with_info(
                r.replay, r.generator, cfg.batch_size, gamma=h.gamma, beta=h.per_beta
            )
            _, loss, td = update(r.train, batch, weights, h)
            replay.update_priorities(r.replay, info, td)
            loss_sum = loss_sum + loss
        return loss_sum, cfg.updates_per_step

    def _maybe_sync(r: RunnerState, on_device: bool = False) -> None:
        """Hard target sync on the configured cadence; with ``target_tau``
        set the update step does a Polyak update instead.  ``on_device``
        (a superstep's graph) decides the ``steps`` cadence on the device
        frame counter, as a select that copies every bit where it syncs."""
        if cfg.target_tau is not None:
            return
        if cfg.target_sync_mode == "steps":
            if on_device:
                sync_target(r.train, r.device_env_step % r.hyper.target_sync_every == 0)
            elif r.env_step % r.hyper.target_sync_every == 0:
                sync_target(r.train)
        elif cfg.target_sync_mode == "episodes":
            # the episode count lives on the device: decide there; under a
            # group on the count summed over the ranks, so that every rank
            # syncs on the same frames (and keeps the global count)
            episodes = r.episodes
            if group is not None:
                episodes = episodes.clone()
                dist.all_reduce(episodes, group=group)
            k = r.hyper.target_replace_episodes
            do_sync = (episodes // k) > (r.last_sync_episodes // k)
            sync_target(r.train, do_sync)
            r.last_sync_episodes.copy_(torch.where(do_sync, episodes, r.last_sync_episodes))
        else:
            raise ValueError(f"unknown target_sync_mode {cfg.target_sync_mode!r}")

    if graphed_learner and venv.graphed:
        return init_runner, GraphedLearner(venv, env_params, replay, update, cfg, device,
                                           _maybe_sync, train_gate, group)

    def superstep(r: RunnerState) -> Tuple[RunnerState, SuperstepMetrics]:
        # the lander's reset runs physics: one reset pool per superstep
        fresh = None if venv.env.batch_reset_cheap else venv.fresh_pool(r.generator, env_params)
        loss_sum = torch.zeros((), device=device)
        loss_count = 0
        ep_delta = torch.zeros((), dtype=torch.int64, device=device)
        ret_delta = torch.zeros((), device=device)

        for _ in range(cfg.steps_per_superstep):
            # --- actor, env step, replay write, episode accounting ----------
            eps = epsilon_by_schedule(cfg, r.env_step * global_envs, r.episodes, r.hyper)
            with torch.no_grad():
                q_values = r.train.online(r.obs)
            num_done, ret_done = _act_and_step(r, venv, env_params, replay, q_values, eps, fresh)
            ret_delta = ret_delta + ret_done
            ep_delta = ep_delta + num_done

            # --- learner ----------------------------------------------------
            r.env_step += 1
            r.device_env_step.add_(1)
            loss_sum, updates = _maybe_train(r, loss_sum)
            loss_count += updates
            _maybe_sync(r)

        eps = epsilon_by_schedule(cfg, r.env_step * global_envs, r.episodes, r.hyper)
        return r, _read_metrics(r, loss_sum, loss_count, ep_delta, ret_delta, eps, cfg, group)

    return init_runner, superstep


def _read_member_metrics(r: RunnerState, loss_sum, loss_count, ep_delta, ret_delta, eps,
                         cfg) -> SuperstepMetrics:
    """A population superstep's metrics, in its one device->host read."""
    threshold = math.inf if cfg.solve_threshold is None else cfg.solve_threshold
    episodes, ep_d, ret_d, loss_s, mean, filled, eps_v = torch.stack([
        r.episodes.to(torch.float64),
        ep_delta.to(torch.float64),
        ret_delta.to(torch.float64),
        loss_sum.to(torch.float64),
        _window_mean(r).to(torch.float64),
        r.window_filled.to(torch.float64),
        eps.to(torch.float64),
    ]).cpu().numpy()
    return SuperstepMetrics(
        env_steps=r.env_step,
        episodes=episodes.astype(np.int64),
        episodes_delta=ep_d.astype(np.int64),
        return_sum_delta=ret_d,
        loss_sum=loss_s,
        loss_count=loss_count,
        window_mean=mean,
        epsilon=eps_v,
        solved=(filled >= cfg.return_window) & (mean >= threshold),
    )


def build_population_superstep(
    venv: VectorEnv,
    env_params: Any,
    network: torch.nn.Module,
    optimizer,
    replay,
    cfg,
    device,
    members: int,
    graphed_learner: bool = True,
) -> Tuple[Callable, Callable]:
    """Build ``(init_population, population_step)`` for ``members`` learners
    of ``cfg`` in lockstep: ``venv`` holds ``members · cfg.num_envs`` envs,
    ``network`` is a ``models.MemberQNetwork`` and ``replay`` a replay built
    with ``members``.

    ``init_population(seed) -> RunnerState``: member ``m``'s network is
    initialised as a single learner's from the ``m``-th seed derived from
    ``seed``, and every member starts with its own buffer, counters and the
    config's hyperparameters.  ``population_step(runner) -> (runner,
    SuperstepMetrics)`` advances ``runner`` in place; each metric but
    ``env_steps`` is an (M,) array.

    ``population_step`` is a :class:`GraphedPopulation` where
    ``graphed_learner`` is set and ``venv`` graphs its step (the lander and
    the classic envs), with either replay; else each frame runs eagerly,
    with the same results."""
    device = torch.device(device)
    update = build_update_step(optimizer, cfg)
    num_envs = venv.num_envs // members
    cadence = {}  # host cadence tuples as device tensors, made once each

    def as_tensor(values, dtype=torch.int64) -> torch.Tensor:
        if (values, dtype) not in cadence:
            cadence[values, dtype] = torch.tensor(values, dtype=dtype, device=device)
        return cadence[values, dtype]

    def init_population(seed: int) -> RunnerState:
        seeds = _seeds(seed, members + 1)
        online = copy.deepcopy(network).to("cpu")
        online.reset_parameters(
            [torch.Generator().manual_seed(_seeds(s, 2)[0]) for s in seeds[:members]]
        )
        train = init_train_state(online.to(device), optimizer)
        generator = torch.Generator(device=device).manual_seed(seeds[-1])
        obs, env_states = venv.reset(generator, env_params)
        rows = venv.num_envs
        example = Transition(
            obs=obs,
            action=torch.zeros((rows,), dtype=torch.int32, device=device),
            reward=torch.zeros((rows,), device=device),
            next_obs=obs,
            terminated=torch.zeros((rows,), dtype=torch.bool, device=device),
            truncated=torch.zeros((rows,), dtype=torch.bool, device=device),
        )
        zero = torch.zeros((members,), dtype=torch.int64, device=device)
        return RunnerState(
            train=train,
            hyper=MemberHyperParams.from_config(cfg, members, device),
            env_states=env_states,
            obs=obs,
            replay=replay.init(example),
            generator=generator,
            env_step=0,
            device_env_step=torch.zeros((), dtype=torch.int64, device=device),
            episodes=zero.clone(),
            last_sync_episodes=zero.clone(),
            ep_return=torch.zeros((members, num_envs), device=device),
            ep_length=torch.zeros((members, num_envs), dtype=torch.int32, device=device),
            return_window=torch.zeros((members, cfg.return_window), device=device),
            window_cursor=zero.clone(),
            window_filled=zero.clone(),
        )

    def train_gates(h, env_step: int, filled: int):
        """Each member's cadence and warm-up gate after vector step
        ``env_step`` with ``filled`` slots a row stored (host counters):
        the host bools, or None if none is open."""
        stored = filled * num_envs
        gates = tuple(env_step % k == 0 and stored >= start
                      for k, start in zip(h.train_every, h.training_start))
        return gates if any(gates) else None

    def _maybe_train(r: RunnerState, loss_sum: torch.Tensor):
        """``cfg.updates_per_step`` updates of the members whose gate is
        open, each loss added into ``loss_sum`` (a closed gate's as 0);
        the gates, or None if none is open."""
        gates = train_gates(r.hyper, r.env_step, r.replay.filled)
        if gates is None:
            return None
        mask, h = as_tensor(gates, torch.bool), r.hyper
        for _ in range(cfg.updates_per_step):
            batch, info, weights = replay.sample_with_info(
                r.replay, r.generator, cfg.batch_size, gamma=h.gamma, beta=h.per_beta
            )
            _, loss, td = update(r.train, batch, weights, h, mask, advance=False)
            replay.update_priorities(r.replay, info, td, mask)
            loss_sum.add_(torch.where(mask, loss, 0.0))
            advance_members(r.train, gates)
        return gates

    def _maybe_sync(r: RunnerState, on_device: bool = False) -> None:
        """Each member's hard target sync on its own cadence; with
        ``target_tau`` set the update step does a Polyak update instead.
        ``on_device``: the ``steps`` cadence decided on the device frame
        counter (a superstep's graph)."""
        if cfg.target_tau is not None:
            return
        if cfg.target_sync_mode == "steps":
            if on_device:
                every = as_tensor(r.hyper.target_sync_every)
                sync_target(r.train, r.device_env_step % every == 0)
                return
            mask = [r.env_step % k == 0 for k in r.hyper.target_sync_every]
            if any(mask):
                sync_target(r.train, as_tensor(tuple(mask), torch.bool))
        elif cfg.target_sync_mode == "episodes":
            k = as_tensor(r.hyper.target_replace_episodes)
            do_sync = (r.episodes // k) > (r.last_sync_episodes // k)
            sync_target(r.train, do_sync)
            r.last_sync_episodes.copy_(torch.where(do_sync, r.episodes, r.last_sync_episodes))
        else:
            raise ValueError(f"unknown target_sync_mode {cfg.target_sync_mode!r}")

    if graphed_learner and venv.graphed:
        return init_population, GraphedPopulation(venv, env_params, replay, update, cfg, device,
                                                  _maybe_sync, train_gates, members, as_tensor)

    def population_step(r: RunnerState) -> Tuple[RunnerState, SuperstepMetrics]:
        fresh = None if venv.env.batch_reset_cheap else venv.fresh_pool(r.generator, env_params)
        loss_sum = torch.zeros((members,), device=device)
        loss_count = np.zeros((members,), dtype=np.int64)
        ep_delta = torch.zeros((members,), dtype=torch.int64, device=device)
        ret_delta = torch.zeros((members,), device=device)

        for _ in range(cfg.steps_per_superstep):
            eps = epsilon_by_schedule(cfg, r.env_step * num_envs, r.episodes, r.hyper)
            with torch.no_grad():
                q_values = r.train.online(r.obs.view(members, num_envs, -1))
            num_done, ret_done = _act_and_step(
                r, venv, env_params, replay, q_values.view(members * num_envs, -1),
                eps.repeat_interleave(num_envs), fresh,
            )
            ret_delta = ret_delta + ret_done
            ep_delta = ep_delta + num_done

            r.env_step += 1
            r.device_env_step.add_(1)
            gates = _maybe_train(r, loss_sum)
            if gates is not None:
                loss_count += np.asarray(gates) * cfg.updates_per_step
            _maybe_sync(r)

        eps = epsilon_by_schedule(cfg, r.env_step * num_envs, r.episodes, r.hyper)
        return r, _read_member_metrics(r, loss_sum, loss_count, ep_delta, ret_delta, eps, cfg)

    return init_population, population_step

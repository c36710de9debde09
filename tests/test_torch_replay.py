"""The port's replay (uniform ring, PER, n-step assembly) against the JAX
package on the same data and the same draws.

Priorities are small integers, so every cumulative sum is exact and the
sampled indices must be identical.  The JAX package's one-hot priority
update normalises duplicate sums by their count, which is not exact for 3
or more duplicates: priorities are compared to 4 float32 ulps (rtol 5e-7).
The n-step batch from the same ``(env_idx, slot_idx)`` is compared to 1
ulp (rtol 1.2e-7): ``gamma ** k`` comes from two pow implementations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.envs.base import Transition as JaxTransition
from deep_q_learning_tpu.replay import PrioritizedReplay as JaxPER
from deep_q_learning_tpu.replay import SampleInfo as JaxInfo
from deep_q_learning_tpu.replay.nstep import assemble_learn_batch as jax_assemble
from deep_q_learning_tpu.replay.nstep import valid_slot_mask as jax_valid_mask
from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.replay import (
    PrioritizedReplay,
    SampleInfo,
    UniformReplay,
    assemble_learn_batch,
    valid_slot_mask,
)

N, C, D = 3, 8, 2


def _transition(rng, n=N):
    x = dict(
        obs=rng.standard_normal((n, D)).astype(np.float32),
        action=rng.integers(0, 4, n).astype(np.int32),
        reward=rng.standard_normal(n).astype(np.float32),
        next_obs=rng.standard_normal((n, D)).astype(np.float32),
        terminated=rng.random(n) < 0.2,
        truncated=rng.random(n) < 0.1,
    )
    return (
        JaxTransition(**{k: jnp.asarray(v) for k, v in x.items()}),
        Transition(**{k: torch.tensor(v) for k, v in x.items()}),
    )


def _filled_pair(adds, alpha=0.6, n_step=3, seed=0, td_every=0):
    """JAX and port PER after the same ``adds`` writes (and, every
    ``td_every`` adds, the same priority update)."""
    rng = np.random.default_rng(seed)
    kw = dict(alpha=alpha, beta=0.4, eps=1e-6, max_decay=0.999, gamma=0.97, n_step=n_step)
    jr, tr = JaxPER(N, C, **kw), PrioritizedReplay(N, C, **kw)
    tj, tt = _transition(rng)
    js, ts = jr.init(tj), tr.init(tt)
    for i in range(adds):
        tj, tt = _transition(rng)
        js, ts = jr.add(js, tj), tr.add(ts, tt)
        if td_every and i % td_every == td_every - 1:
            env = rng.integers(0, N, 4)
            slot = rng.integers(0, min(i + 1, C), 4)
            td = (rng.standard_normal(4) * 3).astype(np.float32)
            js = jr.update_priorities(js, JaxInfo(jnp.asarray(env), jnp.asarray(slot)), jnp.asarray(td))
            tr.update_priorities(ts, SampleInfo(torch.tensor(env), torch.tensor(slot)), torch.tensor(td))
    return jr, js, tr, ts


@pytest.mark.parametrize("adds", [5, 13])
def test_add_matches_jax(adds):
    _, js, _, ts = _filled_pair(adds, td_every=3)
    for name in ("obs", "next_obs", "aux"):
        np.testing.assert_array_equal(
            getattr(ts.storage, name).numpy(), np.asarray(getattr(js.storage, name))
        )
    np.testing.assert_allclose(ts.priorities.numpy(), np.asarray(js.priorities), rtol=5e-7)
    np.testing.assert_allclose(float(ts.max_priority), float(js.max_priority), rtol=1e-7)
    assert (ts.cursor, ts.total_adds) == (int(js.cursor), int(js.total_adds))


@pytest.mark.parametrize("adds", [6, 20])
def test_sample_indices_and_weights_match_jax(adds):
    jr, js, tr, ts = _filled_pair(adds)
    ints = np.random.default_rng(1).integers(0, 6, (N, C)).astype(np.float32)
    js = js.replace(priorities=jnp.asarray(ints))
    ts.priorities = torch.tensor(ints)
    b, key = 64, jax.random.PRNGKey(3)
    batch_j, info_j, w_j = jr.sample_with_info(js, key, b)
    env_key, slot_key = jax.random.split(key)
    u = (jax.random.uniform(env_key, (b,)), jax.random.uniform(slot_key, (b,)))
    batch_t, info_t, w_t = tr.sample_with_info(
        ts, None, b, uniforms=tuple(torch.tensor(np.asarray(x)) for x in u)
    )
    np.testing.assert_array_equal(info_t.env_idx.numpy(), np.asarray(info_j.env_idx))
    np.testing.assert_array_equal(info_t.slot_idx.numpy(), np.asarray(info_j.slot_idx))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    for name in ("obs", "action", "reward", "next_obs", "bootstrap"):
        np.testing.assert_allclose(
            getattr(batch_t, name).numpy(), np.asarray(getattr(batch_j, name)), rtol=1.2e-7
        )


@pytest.mark.parametrize("large_n", [False, True])
def test_update_priorities_matches_both_jax_branches(large_n):
    """The JAX update has a one-hot branch and, when B·(N+C) > 2^22, a
    scatter branch; the port's set-to-0 + scatter_reduce(amax) matches both,
    duplicates (here up to 4 of one pair) resolving max-wins."""
    n, c = (2, 1 << 20) if large_n else (N, C)
    jr = JaxPER(n, c, alpha=0.6, eps=1e-6, max_decay=0.5)
    tr = PrioritizedReplay(n, c, alpha=0.6, eps=1e-6, max_decay=0.5)
    rng = np.random.default_rng(2)
    pri = rng.integers(0, 4, (n, c)).astype(np.float32)
    env = np.array([0, 1, 0, 0, 1, 0, 0], np.int64)
    slot = np.array([1, 2, 1, 1, 2, 5, 1], np.int64)
    td = np.array([0.5, -2.0, 3.0, -1.0, 0.25, 7.0, 2.0], np.float32)
    assert (len(td) * (n + c) > (1 << 22)) == large_n  # which JAX branch runs
    js = jr.init(JaxTransition(
        obs=jnp.zeros((n, 1)), action=jnp.zeros((n,), jnp.int32), reward=jnp.zeros((n,)),
        next_obs=jnp.zeros((n, 1)), terminated=jnp.zeros((n,), bool),
        truncated=jnp.zeros((n,), bool),
    )).replace(priorities=jnp.asarray(pri), max_priority=jnp.float32(4.0))
    js = jr.update_priorities(js, JaxInfo(jnp.asarray(env), jnp.asarray(slot)), jnp.asarray(td))
    ts = tr.init(Transition(
        obs=torch.zeros((n, 1)), action=torch.zeros((n,), dtype=torch.int32),
        reward=torch.zeros(n), next_obs=torch.zeros((n, 1)),
        terminated=torch.zeros(n, dtype=torch.bool), truncated=torch.zeros(n, dtype=torch.bool),
    ))
    ts.priorities.copy_(torch.tensor(pri))
    ts.max_priority = torch.tensor(4.0)
    tr.update_priorities(ts, SampleInfo(torch.tensor(env), torch.tensor(slot)), torch.tensor(td))
    got, want = ts.priorities.numpy(), np.asarray(js.priorities)
    np.testing.assert_allclose(got, want, rtol=5e-7)
    np.testing.assert_allclose(got[0, 1], (3.0 + 1e-6) ** 0.6, rtol=1e-6)  # max of 4 writes
    np.testing.assert_allclose(float(ts.max_priority), float(js.max_priority), rtol=1e-7)


def test_assemble_learn_batch_identical_from_same_indices():
    jr, js, tr, ts = _filled_pair(30, seed=4)  # wrapped more than once
    rng = np.random.default_rng(9)
    env = rng.integers(0, N, 128)
    slot = rng.integers(0, C, 128)
    for n_step, trunc_boot in [(1, True), (3, True), (3, False)]:
        bj = jax_assemble(js.storage, jnp.asarray(env), jnp.asarray(slot), 0.97, n_step, trunc_boot)
        bt = assemble_learn_batch(ts.storage, torch.tensor(env), torch.tensor(slot), 0.97, n_step, trunc_boot)
        for name in ("obs", "action", "next_obs"):
            np.testing.assert_array_equal(getattr(bt, name).numpy(), np.asarray(getattr(bj, name)))
        for name in ("reward", "bootstrap"):
            np.testing.assert_allclose(
                getattr(bt, name).numpy(), np.asarray(getattr(bj, name)), rtol=1.2e-7, atol=0
            )


@pytest.mark.parametrize("cursor,filled", [(0, 0), (5, 5), (3, 8), (0, 8)])
def test_valid_slot_mask_matches_jax(cursor, filled):
    want = np.asarray(jax_valid_mask(C, jnp.int32(cursor), jnp.int32(filled), 3))
    np.testing.assert_array_equal(valid_slot_mask(C, cursor, filled, 3).numpy(), want)


def test_uniform_replay_samples_valid_windows():
    rng = np.random.default_rng(0)
    replay = UniformReplay(N, C, gamma=0.9, n_step=3)
    _, tt = _transition(rng)
    state = replay.init(tt)
    for _ in range(11):  # wraps the ring
        replay.add(state, _transition(rng)[1])
    assert (state.cursor, state.filled) == (11 % C, C)
    batch, info, w = replay.sample_with_info(state, torch.Generator().manual_seed(0), 256)
    assert info is None and torch.equal(w, torch.ones(256))
    mask = valid_slot_mask(C, state.cursor, state.filled, 3)
    # every sampled start obs lies in a slot whose 3-step window is stored
    starts = {tuple(r) for r in batch.obs.numpy().tolist()}
    valid = {
        tuple(state.storage.obs[s, e].tolist()) for s in range(C) if mask[s] for e in range(N)
    }
    assert starts <= valid

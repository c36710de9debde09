"""The PER slot-sampling kernel's plain version (``ops/sample_kernels.py``)
and the port's sampler with ``use_pallas=True``, against the JAX package's
Pallas kernel run in interpret mode on the same inputs.

Tolerances:
* Dyadic priorities (multiples of 1/64 with small totals) make every sum
  exact in any order, so ``slot_idx`` must match exactly.
* Random float priorities: the Pallas kernel sums the row with ``jnp.sum``
  and its prefixes in 128-wide matmul blocks with a carry, the plain version
  with ``torch.sum`` and ``torch.cumsum``.  A draw within a few ulps of a
  prefix may then fall on the other side of it.  A mismatch is allowed only
  where every prefix between the two slots lies within 8 float32 ulps of
  the row total of the reference's draw, and in under 1 % of at least 1024
  draws (at C = 20000 the float32 prefix sums of either side miss the exact
  count in a few draws of a thousand).
* The whole sampler: indices exact, importance weights rtol 1e-6.
* A population's members: one call over every member's rows (M·N, C)
  against the Pallas sampler vmapped over the members, each member's
  slot uniforms from its own key: exact on dyadic priorities; and equal to
  M separate calls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from deep_q_learning_tpu.envs.base import Transition as JaxTransition
from deep_q_learning_tpu.ops.sample_kernels import _slot_kernel, prioritized_sample_pallas
from deep_q_learning_tpu.replay import PrioritizedReplay as JaxPER
from deep_q_learning_tpu_torch.envs.base import Transition
from deep_q_learning_tpu_torch.ops import sample_kernels
from deep_q_learning_tpu_torch.ops.sample_kernels import (
    slot_select,
    slot_select_members,
    slot_select_reference,
)
from deep_q_learning_tpu_torch.replay import PrioritizedReplay

ULPS = 8
SHARE_DRAWS = 1024  # random priorities: the share of mismatches is over at least this many draws


def pallas_slots(priorities, env_idx, u_slot):
    """The JAX package's Pallas kernel on given ``env_idx`` and ``u_slot``,
    launched as ``prioritized_sample_pallas`` launches it, in interpret mode."""
    n, c = priorities.shape
    b = len(env_idx)
    kernel = functools.partial(_slot_kernel, batch_size=b, num_envs=n, capacity=c)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b, 1), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(
        jnp.asarray(env_idx, jnp.int32).reshape(b, 1),
        jnp.asarray(u_slot, jnp.float32).reshape(b, 1),
        jnp.asarray(priorities),
    )
    return np.asarray(out[:, 0])


def port_slots(priorities, env_idx, u_slot):
    return slot_select(
        torch.tensor(priorities), torch.tensor(env_idx, dtype=torch.int64), torch.tensor(u_slot)
    ).numpy()


def dyadic_priorities(rng, n, c, zero_frac=0.3):
    p = rng.integers(1, 257, (n, c)) / 64.0
    p[rng.random((n, c)) < zero_frac] = 0.0
    return p.astype(np.float32)


def u_slot_of(key, b):
    """The slot uniforms ``prioritized_sample_pallas`` draws from ``key``."""
    _, slot_key = jax.random.split(key)
    return np.asarray(jax.random.uniform(slot_key, (b,), jnp.float32))


# (N, C, B) of lunar_per, lunar_per_scaled(1024) and lunar_per_scaled(4096) with the
# sampler on; then the kernel's scalar path (C % 4 != 0) and its chunk loop (C > 16384)
@pytest.mark.parametrize("n,c,b", [(128, 4096, 256), (1024, 512, 1024), (5, 200, 37),
                                   (4096, 128, 4096), (5, 37, 64), (3, 20000, 64)])
def test_plain_matches_pallas_exactly_on_dyadic_priorities(n, c, b):
    p = dyadic_priorities(np.random.default_rng(n + c + b), n, c)
    p[1] = 0.0  # an all-zero row
    key = jax.random.PRNGKey(n)
    env_j, slot_j, _ = prioritized_sample_pallas(jnp.asarray(p), key, b, interpret=True)
    env_idx = np.asarray(env_j)
    sample_kernels.reset_counts()
    got = port_slots(p, env_idx, u_slot_of(key, b))
    assert sample_kernels.plain_calls == {"per_slot_sample": 1}
    assert sample_kernels.launches == {"per_slot_sample": 0}
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(slot_j))
    assert len(set(got.tolist())) > 1


@pytest.mark.parametrize("n,c,b", [(128, 4096, 256), (1024, 512, 1024), (7, 200, 37),
                                   (5, 37, 64), (3, 20000, 64)])
def test_plain_matches_pallas_within_ulps_on_random_priorities(n, c, b):
    rng = np.random.default_rng(c)
    p = (rng.random((n, c)) ** 3).astype(np.float32)
    # ceil(SHARE_DRAWS / b) batches of b draws in one call: each draw stands alone
    draws = -(-SHARE_DRAWS // b) * b
    env_idx = rng.integers(0, n, draws)
    u = rng.random(draws).astype(np.float32)
    want = pallas_slots(p, env_idx, u)
    got = port_slots(p, env_idx, u)
    rows = p[env_idx].astype(np.float64)
    cdf = np.cumsum(rows, axis=1)
    total = rows.sum(axis=1).astype(np.float32)
    draw = u.astype(np.float64) * total
    for i in np.flatnonzero(got != want):
        lo, hi = sorted((got[i], want[i]))
        gap = np.abs(cdf[i, lo:hi] - draw[i]).max()
        assert gap <= ULPS * np.spacing(total[i]), (i, got[i], want[i], gap)
    assert (got != want).mean() < 0.01


def test_edge_semantics_match_pallas():
    """Leading zero slots with u = 0, an all-zero row, a draw past the total
    (u >= 1), rows outside [0, N), and C not a multiple of 128."""
    n, c = 4, 200
    p = dyadic_priorities(np.random.default_rng(0), n, c, zero_frac=0.0)
    p[0, :17] = 0.0  # leading masked slots
    p[2] = 0.0  # all-zero row
    env_idx = np.array([0, 0, 2, 2, 1, 3, 1, -1, n, 3, 0])
    u = np.array([0.0, 0.5, 0.0, 0.7, 1.5, 1.0, 0.999999, 0.3, 0.3, 1e-7, 0.25], np.float32)
    want = pallas_slots(p, env_idx, u)
    got = port_slots(p, env_idx, u)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[2] == got[3] == 0  # u = 0; all-zero row
    assert got[4] == c - 1  # past the total: clamped
    assert got[7] == got[8] == 0  # no row: as the one-hot gather of nothing


def test_wrapper_checks_its_inputs():
    p = torch.zeros((3, 8))
    env = torch.zeros(5, dtype=torch.int64)
    u = torch.zeros(5)
    with pytest.raises(TypeError):
        slot_select(p, env.to(torch.int32), u)
    with pytest.raises(ValueError):
        slot_select(p, env, torch.zeros(4))
    with pytest.raises(ValueError):
        slot_select(p.t(), env, u)  # not contiguous
    with pytest.raises(ValueError):
        slot_select(p, env.to("meta"), u)
    np.testing.assert_array_equal(slot_select_reference(p, env, u).numpy(), np.zeros(5))


N, C = 6, 40


def _pair(adds, seed):
    """JAX and port PER with ``use_pallas=True`` after the same writes."""
    rng = np.random.default_rng(seed)
    kw = dict(alpha=0.6, beta=0.4, eps=1e-6, max_decay=0.999, gamma=0.97, n_step=3,
              use_pallas=True)
    jr, tr = JaxPER(N, C, **kw), PrioritizedReplay(N, C, **kw)

    def transition():
        x = dict(
            obs=rng.standard_normal((N, 3)).astype(np.float32),
            action=rng.integers(0, 4, N).astype(np.int32),
            reward=rng.standard_normal(N).astype(np.float32),
            next_obs=rng.standard_normal((N, 3)).astype(np.float32),
            terminated=rng.random(N) < 0.1,
            truncated=rng.random(N) < 0.05,
        )
        return (JaxTransition(**{k: jnp.asarray(v) for k, v in x.items()}),
                Transition(**{k: torch.tensor(v) for k, v in x.items()}))

    tj, tt = transition()
    js, ts = jr.init(tj), tr.init(tt)
    for _ in range(adds):
        tj, tt = transition()
        js, ts = jr.add(js, tj), tr.add(ts, tt)
    pri = dyadic_priorities(rng, N, C)
    return jr, js.replace(priorities=jnp.asarray(pri)), tr, ts, pri


@pytest.mark.parametrize("adds,b", [(12, 37), (55, 256)])
def test_sampler_with_kernel_matches_jax_pallas_sampler(adds, b):
    """The whole sampler with injected draws: JAX's ``jax.random.split(key)``
    uniforms go to the port as ``uniforms``."""
    jr, js, tr, ts, pri = _pair(adds, seed=adds)
    ts.priorities = torch.tensor(pri)
    key = jax.random.PRNGKey(adds)
    batch_j, info_j, w_j = jr.sample_with_info(js, key, b)
    env_key, slot_key = jax.random.split(key)
    u = (jax.random.uniform(env_key, (b,)), jax.random.uniform(slot_key, (b,)))
    sample_kernels.reset_counts()
    batch_t, info_t, w_t = tr.sample_with_info(
        ts, None, b, uniforms=tuple(torch.tensor(np.asarray(x)) for x in u)
    )
    assert sample_kernels.plain_calls == {"per_slot_sample": 1}
    np.testing.assert_array_equal(info_t.env_idx.numpy(), np.asarray(info_j.env_idx))
    np.testing.assert_array_equal(info_t.slot_idx.numpy(), np.asarray(info_j.slot_idx))
    assert info_t.slot_idx.dtype == torch.int64
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6)
    for name in ("obs", "action", "next_obs"):
        np.testing.assert_array_equal(
            getattr(batch_t, name).numpy(), np.asarray(getattr(batch_j, name))
        )


@pytest.mark.parametrize("m,n,c,b", [(3, 5, 200, 37), (2, 16, 512, 64), (3, 4, 37, 16)])
def test_members_in_one_call_match_vmapped_pallas(m, n, c, b):
    rng = np.random.default_rng(m * n + c)
    p = np.stack([dyadic_priorities(rng, n, c) for _ in range(m)])
    p[1, 2] = 0.0  # an all-zero row
    keys = jax.random.split(jax.random.PRNGKey(c), m)
    env_j, slot_j, _ = jax.vmap(lambda pk, k: prioritized_sample_pallas(pk, k, b, interpret=True))(
        jnp.asarray(p), keys)
    u = np.stack([u_slot_of(k, b) for k in keys])
    env = torch.tensor(np.asarray(env_j), dtype=torch.int64)
    flat_p = torch.tensor(p.reshape(m * n, c))
    sample_kernels.reset_counts()
    got = slot_select_members(flat_p, env, torch.tensor(u))
    assert sample_kernels.plain_calls == {"per_slot_sample": 1}
    np.testing.assert_array_equal(got.numpy(), np.asarray(slot_j))
    each = [port_slots(p[k], np.asarray(env_j)[k], u[k]) for k in range(m)]
    np.testing.assert_array_equal(got.numpy(), np.stack(each))


def test_members_keep_rows_outside_a_member_empty():
    """An index outside [0, N) of a member selects no row, not a row of
    the next member."""
    p = torch.tensor(dyadic_priorities(np.random.default_rng(1), 6, 40, zero_frac=0.0))
    env = torch.tensor([[-1, 3, 1], [3, -1, 0]])
    u = torch.full((2, 3), 0.6)
    got = slot_select_members(p, env, u)
    assert got[0, 0] == 0 and got[1, 0] == 0 and got[1, 1] == 0
    assert got[0, 1] == port_slots(p[:3].numpy(), np.array([3]), np.array([0.6], np.float32))[0]
    with pytest.raises(ValueError, match="multiple"):
        slot_select_members(p[:5], env, u)

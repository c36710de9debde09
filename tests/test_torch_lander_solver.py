"""The port's jointed lander solver (``deep_q_learning_tpu_torch/envs/
lander_solver.py``) against the JAX module, on the CPU.

States: a JAX rollout of the jointed LunarLander at the presets' (120, 40)
iterations, half the landers flying ``envs/heuristic.py::heuristic_action``
and half random actions, over random and flat terrain, plus the resting
lander of the settle harness.  Each state goes through the JAX function
(vmapped) and the port's batched one.

Tolerances:
* Geometry (``collide_leg``, ``hull_touches``): corner indices, ``block``
  and every flag exact; coordinates atol 1e-6 (float32 of magnitude ~10;
  XLA's sin/cos differ from PyTorch's in the last ulp on ~5 % of inputs).
* One frame of ``assembly_step``: XLA contracts ``a*b + c`` into fused
  multiply-adds and PyTorch does not, so the two float32 evaluations differ
  in the last ulp from the first operations on, and the 120 sequential
  velocity iterations carry that far on hard impacts and ill-conditioned
  2x2 contact blocks.  The ``conditioning`` fixture measures how far: per
  field, the largest gap over the lanes between JAX's float32 frame and
  the same JAX code in float64 (on these states up to 7.5e-3 in a leg's
  angular velocity, 4.1e-3 in a contact impulse, 2.8e-5 in an angle).
  So: on at least 99 % of the lanes the tight tolerances, positions and
  angles atol 1e-5, velocities atol 1e-4, accumulators atol 1e-5 + rtol
  1e-4; and on every lane within 4x that field's float32 gap (plus the
  tight atol).  Measured on 9,030 lanes: 13 past the tight tolerances; the
  largest gaps 1.1e-2 in a leg's angular velocity (1.5x its float32 gap),
  4.2e-5 in an angle.
* Flags of one frame: the contact, hull-hit and joint-limit flags come
  from the start-of-step pose and must match exactly; the sleep flag may
  differ only on lanes whose JAX speed lies within the velocity tolerance
  of a sleep threshold, and on at most 1 % of the lanes.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.envs import lander_solver as J
from deep_q_learning_tpu.envs.heuristic import heuristic_action
from deep_q_learning_tpu.envs.lunar_lander import LunarLander as JaxLander
from deep_q_learning_tpu_torch.envs import lander_solver as T
from deep_q_learning_tpu_torch.envs.lunar_lander import LunarLander, LunarLanderParams

VEL, POS = 120, 40  # the lunar_jointed_* presets' iteration counts
N_ENVS, T_STEPS = 32, 200
BODY = ("cx", "cy", "a", "vx", "vy", "w")
ACC = ("j1", "j2", "s1", "s2", "c1", "c2")
POS_TOL, VEL_TOL, ACC_TOL = 1e-5, 1e-4, (1e-5, 1e-4)  # atol; (atol, rtol)
TIGHT_SHARE = 0.99
CONDITIONING = 4.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cat(trees):
    return jax.tree.map(lambda *x: np.concatenate(x), *trees)


def _jax_params(**kw):
    return JaxLander().default_params().replace(jointed=True, vel_iters=VEL, pos_iters=POS, **kw)


def _rollout(random_terrain, seed):
    """Pre-step states of the live landers along a JAX rollout."""
    env = JaxLander()
    p = _jax_params(random_terrain=random_terrain)
    obs, st = jax.jit(jax.vmap(env.reset, (0, None)))(
        jax.random.split(jax.random.PRNGKey(seed), N_ENVS), p
    )
    step = jax.jit(jax.vmap(env.step, (0, 0, 0, None)))
    heur = jax.jit(jax.vmap(heuristic_action))
    rng = np.random.default_rng(seed)
    alive = np.ones(N_ENVS, bool)
    states = []
    for t in range(T_STEPS):
        acts = np.where(
            np.arange(N_ENVS) % 2 == 0, np.asarray(heur(obs)), rng.integers(0, 4, N_ENVS)
        ).astype(np.int32)
        states.append(jax.tree.map(lambda x: np.asarray(x)[alive], st))
        obs, st, _, term, trunc = step(
            jax.random.split(jax.random.PRNGKey(seed * 1000 + t), N_ENVS), st, jnp.asarray(acts), p
        )
        alive &= ~(np.asarray(term) | np.asarray(trunc))
    return _cat(states)


def _settled():
    """The settle harness's lander on the pad: every frame from touchdown
    to its sleep, one of them asleep."""
    env = JaxLander()
    p = _jax_params(random_terrain=False)
    _, st = env.reset(jax.random.PRNGKey(7), p)
    step = jax.jit(env.step)
    for t in range(25):
        _, st, *_ = step(jax.random.PRNGKey(t), st, jnp.int32(0), p)
    tx = jnp.float32(J.W / 2) - st.x
    ty = jnp.float32(0.99 * 13.333 / 4.0 + 0.75) - st.y

    def move(b):
        return b._replace(cx=b.cx + tx, cy=b.cy + ty, vx=jnp.float32(0.0),
                          vy=jnp.float32(-0.5), w=jnp.float32(0.0))

    st = st.replace(x=st.x + tx, y=st.y + ty, vx=jnp.float32(0.0), vy=jnp.float32(-0.5),
                    omega=jnp.float32(0.0), leg1_body=move(st.leg1_body),
                    leg2_body=move(st.leg2_body), sleep=jnp.int32(0), t=jnp.int32(0))
    states = []
    for t in range(120):
        states.append(jax.tree.map(lambda x: np.asarray(x)[None], st))
        _, st, r, term, _ = step(jax.random.PRNGKey(100 + t), st, jnp.int32(0), p)
        if bool(term):
            break
    assert float(r) == 100.0
    return _cat(states[-30:])


@pytest.fixture(scope="module")
def rollout_states():
    """Every collected pre-step state (numpy leaves): the rollouts over
    random and flat terrain, then the settle harness's lander."""
    return _cat([_rollout(True, 1), _rollout(False, 2), _settled()])


@pytest.fixture(scope="module")
def frame_inputs(rollout_states):
    """``assembly_step`` inputs from every collected state: the hull at its
    COM, wind-like forces on half the lanes."""
    s = rollout_states
    n = s.x.shape[0]
    rng = np.random.default_rng(0)
    on = rng.random(n) < 0.5
    forces = [
        np.where(on, rng.uniform(-15, 15, n), 0.0).astype(np.float32),
        np.zeros(n, np.float32),
        np.where(on, rng.uniform(-1.5, 1.5, n), 0.0).astype(np.float32),
    ]
    hcx, hcy = (np.asarray(v) for v in J.hull_com(s.x, s.y, s.angle))
    hull = J.Body(hcx, hcy, s.angle, s.vx, s.vy, s.omega)
    return hull, s.leg1_body, s.leg2_body, s.terrain, forces, s.solver_acc


def _jax_step(inputs, **kw):
    hull, l1, l2, terrain, (fx, fy, tq), acc = inputs
    fn = jax.jit(jax.vmap(
        lambda h, a, b, ter, x, y, q, ac: J.assembly_step(
            h, a, b, ter, x, y, q, jnp.float32(-10.0), acc=ac, **kw
        )
    ))
    return _np(fn(hull, l1, l2, terrain, fx, fy, tq, acc))


def _t(x):
    return torch.tensor(np.asarray(x))


def _body(b):
    return T.Body(*(_t(getattr(b, f)) for f in BODY))


def _port_step(inputs, **kw):
    hull, l1, l2, terrain, (fx, fy, tq), acc = inputs
    out = T.assembly_step(
        _body(hull), _body(l1), _body(l2), _t(terrain), _t(fx), _t(fy), _t(tq), -10.0,
        acc=T.AssemblyAcc(*(_t(getattr(acc, f)) for f in ACC)), **kw
    )
    return out


def _fields(out):
    """(name, is a velocity, values) of every compared field of an
    ``assembly_step`` result."""
    for name, body in zip(("hull", "leg1", "leg2"), out[:3]):
        for f in BODY:
            yield f"{name}.{f}", f in ("vx", "vy", "w"), getattr(body, f)
    for f in ("j1", "j2", "c1", "c2"):
        yield f, None, getattr(out[7], f)


def _as_f64(values, n):
    if isinstance(values, torch.Tensor):
        values = values.numpy()
    return np.asarray(values, np.float64).reshape(n, -1)


@pytest.fixture(scope="module")
def conditioning(frame_inputs):
    """Per field, the largest gap over the lanes between JAX's float32 frame
    and the same JAX code run in float64: how far float32 rounding carries
    through the solver on these states."""
    ref = _jax_step(frame_inputs, vel_iters=VEL, pos_iters=POS)
    with jax.enable_x64(True):
        wide = jax.tree.map(
            lambda x: x.astype(np.float64) if x.dtype == np.float32 else x, frame_inputs
        )
        ref64 = _jax_step(wide, vel_iters=VEL, pos_iters=POS)
    n = len(ref[3])
    return {
        name: float(np.abs(_as_f64(a, n) - _as_f64(b, n)).max())
        for (name, _, a), (_, _, b) in zip(_fields(ref), _fields(ref64))
    }


def _check_frame(port, ref, conditioning):
    """The module docstring's tolerances; returns the largest gaps and the
    count of lanes past the tight tolerances."""
    n = len(ref[3])
    tight_bad = np.zeros(n, bool)
    gaps = {}
    for (name, is_vel, got), (_, _, want) in zip(_fields(port), _fields(ref)):
        got, want = _as_f64(got, n), _as_f64(want, n)
        if is_vel is None:
            atol, rtol = ACC_TOL
        else:
            atol, rtol = (VEL_TOL if is_vel else POS_TOL), 0.0
        gap = np.abs(got - want)
        tight_bad |= (gap > atol + rtol * np.abs(want)).any(1)
        gaps[name] = float(gap.max())
        bound = CONDITIONING * conditioning[name] + atol
        far = gap.max(1) > bound
        assert not far.any(), (name, np.flatnonzero(far), gaps[name], bound)
    assert tight_bad.mean() <= 1 - TIGHT_SHARE, (tight_bad.sum(), n, gaps)
    # flags decided by the start-of-step pose: exact
    for i, name in ((3, "touch1"), (4, "touch2"), (5, "hull_hit")):
        np.testing.assert_array_equal(port[i].numpy(), ref[i], err_msg=name)
    for f in ("s1", "s2"):
        np.testing.assert_array_equal(getattr(port[7], f).numpy(), getattr(ref[7], f), err_msg=f)
    # the sleep flag, from the end-of-step speeds: only near a threshold
    near = np.zeros(n, bool)
    for b in ref[:3]:
        near |= (np.abs(np.hypot(b.vx, b.vy) - J.LIN_SLEEP_TOL) < VEL_TOL) | (
            np.abs(np.abs(b.w) - J.ANG_SLEEP_TOL) < VEL_TOL)
    flipped = port[6].numpy() != ref[6]
    assert not (flipped & ~near).any() and flipped.mean() <= 0.01, (flipped.sum(), near.sum())
    return gaps, int(tight_bad.sum())


# --------------------------------------------------------------- geometry
def test_collide_and_hull_touches_match_jax(frame_inputs):
    hull, l1, l2, terrain, _, _ = frame_inputs
    collide = jax.jit(jax.vmap(J.collide_leg))
    for leg in (l1, l2):
        want, touch = _np(collide(terrain, leg))
        got, got_touch = T.collide_leg(_t(terrain), _body(leg))
        for f in ("active1", "active2", "block", "idx1", "idx2"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
        np.testing.assert_array_equal(got_touch.numpy(), touch)
        for f in ("nx1", "ny1", "nx2", "ny2", "px1", "py1", "px2", "py2",
                  "lx1", "ly1", "lx2", "ly2", "sx1", "sh1", "sx2", "sh2"):
            np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f), atol=1e-6, err_msg=f)
    hit = np.asarray(jax.jit(jax.vmap(J.hull_touches))(terrain, hull))
    np.testing.assert_array_equal(T.hull_touches(_t(terrain), _body(hull)).numpy(), hit)
    assert hit.any() and not hit.all()


def test_deepest_corner_ties_pick_the_first():
    """A level leg on flat terrain has its two bottom corners (0, 1) at one
    depth and its two top corners (2, 3) at another: argmin must return the
    first of equal minima, as jnp.argmin does."""
    n = 64
    rng = np.random.default_rng(3)
    terrain = np.full((n, J.CHUNKS), 0.99 * 13.333 / 4.0, np.float32)
    z = np.zeros(n, np.float32)
    leg = J.Body(
        rng.uniform(1, 19, n).astype(np.float32),
        (terrain[:, 0] + rng.uniform(-0.2, 0.4, n)).astype(np.float32),
        z, z, z, z,
    )
    want, _ = _np(jax.jit(jax.vmap(J.collide_leg))(terrain, leg))
    got, _ = T.collide_leg(_t(terrain), _body(leg))
    assert (want.idx1 == 0).all() and (want.idx2 == 1).all()
    np.testing.assert_array_equal(got.idx1.numpy(), want.idx1)
    np.testing.assert_array_equal(got.idx2.numpy(), want.idx2)
    np.testing.assert_array_equal(got.active1.numpy(), want.active1)
    assert want.active1.any() and not want.active1.all()


# ---------------------------------------------------------------- one frame
def test_assembly_step_matches_jax(frame_inputs, conditioning):
    ref = _jax_step(frame_inputs, vel_iters=VEL, pos_iters=POS)
    port = _port_step(frame_inputs, vel_iters=VEL, pos_iters=POS)
    # what the states cover
    hull, l1, l2, terrain, _, _ = frame_inputs
    c1, _ = _np(jax.jit(jax.vmap(J.collide_leg))(terrain, l1))
    both = c1.active1 & c1.active2
    t1, t2, hit, still = ref[3:7]
    assert (~t1 & ~t2 & ~hit).sum() > 100, "free flight"
    assert (t1 ^ t2).sum() > 10, "one leg down"
    assert (t1 & t2).sum() > 10, "two legs down"
    assert (both & c1.block).sum() > 10, "2-point block solve"
    assert (c1.active1 & ~(both & c1.block)).sum() > 10, "sequential contact path"
    assert ((ref[7].s1 != 0) | (ref[7].s2 != 0)).sum() > 100, "joint limit active"
    assert hit.sum() > 5, "hull hit"
    assert still.sum() >= 1, "asleep"
    # the tolerances' premise: float32 JAX is this far from float64
    assert conditioning["leg2.w"] > 1e-4
    gaps, tight_misses = _check_frame(port, ref, conditioning)
    print(f"float32 conditioning (JAX float32 vs float64): {conditioning}")
    print(f"largest gaps over {len(t1)} lanes: {gaps}; lanes past the tight tolerances: "
          f"{tight_misses}")


def test_vel_tol_branch_matches_jax(frame_inputs, conditioning):
    """The early-exit branch: each lane stops once its accumulators change
    by less than vel_tol in an iteration, and keeps its state from then on.
    Iteration counts match JAX's but where the change lies within the
    tolerances of vel_tol."""
    kw = dict(vel_iters=VEL, pos_iters=POS, vel_tol=1e-4, return_iters=True)
    ref = _jax_step(frame_inputs, **kw)
    port = _port_step(frame_inputs, **kw)
    _check_frame(port[:8], ref[:8], conditioning)
    used, want = port[8].numpy(), ref[8]
    assert used.dtype == np.int32 and (used >= 1).all() and (used <= VEL).all()
    assert (want < VEL).mean() > 0.5, "most lanes must exit early"
    assert (used != want).mean() <= 0.01, ((used != want).sum(), len(used))


def test_position_loop_mask_equals_early_exit(frame_inputs, conditioning):
    """JAX leaves the position loop once every lane is done, and a lane that
    is done keeps its values; the port runs every pass with the same mask
    and no host read.  A lane whose JAX values are the same at 40 and 60
    passes was done by pass 40, so on those lanes JAX at 60 is the early
    exit; the port's 60 masked passes must equal its own 40 bit for bit
    there, and hold the tolerances against JAX at 60 on every lane."""
    ref60 = _jax_step(frame_inputs, vel_iters=VEL, pos_iters=60)
    port60 = _port_step(frame_inputs, vel_iters=VEL, pos_iters=60)
    ref40 = _jax_step(frame_inputs, vel_iters=VEL, pos_iters=40)
    port40 = _port_step(frame_inputs, vel_iters=VEL, pos_iters=40)
    _check_frame(port60, ref60, conditioning)
    done40 = np.ones(len(ref60[3]), bool)
    for a, b in zip(ref40[:3], ref60[:3]):
        for f in ("cx", "cy", "a"):
            done40 &= getattr(a, f) == getattr(b, f)
    assert done40.mean() > 0.9 and not done40.all()
    lanes = torch.from_numpy(done40)
    for a, b in zip(port40[:3], port60[:3]):
        for f in BODY:
            assert torch.equal(getattr(a, f)[lanes], getattr(b, f)[lanes]), f


# ------------------------------------------------------------------ settle
def test_settle_rest_pose_and_no_sink():
    """The settle harness of tests/test_lander_solver.py on the port at the
    presets' (120, 40): a soft vertical drop onto the pad comes to rest
    with +100, both legs at |rel angle| in (0.30, 0.42), no sink."""
    t0 = time.perf_counter()
    env = LunarLander()
    p = LunarLanderParams(random_terrain=False, vel_iters=VEL, pos_iters=POS)
    g = torch.Generator().manual_seed(7)
    _, st = env.reset_env(g, 1, p)
    nop = torch.zeros(1, dtype=torch.int32)
    for _ in range(25):  # the legs swing to their flight pose
        _, st, _, term, _ = env.step_env(g, st, nop, p)
    assert not bool(term)
    # rigid translate of the whole assembly to just above the pad
    tx = T.W / 2 - st.x
    ty = 0.99 * 13.333 / 4.0 + 0.75 - st.y
    drop = torch.full((1,), -0.5)

    def move(b):
        return T.Body(b.cx + tx, b.cy + ty, b.a, torch.zeros(1), drop, torch.zeros(1))

    st.x, st.y = st.x + tx, st.y + ty
    st.vx, st.vy, st.omega = torch.zeros(1), drop, torch.zeros(1)
    st.leg1_body, st.leg2_body = move(st.leg1_body), move(st.leg2_body)
    st.sleep, st.t = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    traj = []
    for _ in range(120):
        _, st, r, term, _ = env.step_env(g, st, nop, p)
        traj.append((float(st.y), float(st.vy), float(r),
                     float(st.leg1_body.a - st.angle) + 0.05,
                     float(st.leg2_body.a - st.angle) - 0.05))
        if bool(term):
            break
    assert bool(term) and traj[-1][2] == 100.0, "the drop must come to rest with +100"
    ys = [t[0] for t in traj[-10:]]
    assert max(ys) - min(ys) < 1e-3, "sinking or bouncing at rest"
    assert max(abs(t[1]) for t in traj[-10:]) < T.LIN_SLEEP_TOL
    for rel in traj[-1][3:]:
        assert 0.30 < abs(rel) < 0.42, traj[-1]
    print(f"settled in {len(traj)} frames, {time.perf_counter() - t0:.1f} s on the CPU")

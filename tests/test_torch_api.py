"""The port's public surface against the JAX package's, on the CPU.

* Every public name of every JAX module (top-level ``def``, ``class`` and
  assignment, a package's re-exports, and each public class's methods and
  properties, read from the source) imports from the port's module of the
  same path, apart from the names that differ by design (``BY_DESIGN``,
  the list in ROADMAP.md): each renamed one has its counterpart.
* ``UniformReplay.sample`` on ``tests/test_replay.py``'s cases (the env
  and slot ranges, the reward equal to the encoded step, coverage), and
  its gather equal to JAX's on the indices JAX draws; ``can_sample`` on
  both replays with JAX's gate cases.
* ``Environment.reset``/``step`` are ``reset_env``/``step_env`` (bitwise,
  from the same generator state), through the wrappers too; ``name`` as in
  JAX; the lander's ``LEG_H`` and ``HULL_MASS``.
* ``ops.fused_td_loss`` against the JAX ``fused_td_loss`` with the Pallas
  kernels in interpret mode: loss and td rtol 1e-5, dQ rtol 1e-4 (the
  kernel table's tolerances), differentiable in ``q_s`` only.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_q_learning_tpu.envs import lunar_lander as jax_lander
from deep_q_learning_tpu.envs.base import Transition as JaxTransition
from deep_q_learning_tpu.envs.lunar_lander import LunarLander as JaxLunarLander
from deep_q_learning_tpu.envs.wrappers import TimeFractionObs as JaxTimeFractionObs
from deep_q_learning_tpu.ops.td_kernels import fused_td_loss as jax_fused_td_loss
from deep_q_learning_tpu.replay import UniformReplay as JaxUniformReplay
from deep_q_learning_tpu_torch import ops
from deep_q_learning_tpu_torch.envs import (
    Acrobot,
    CartPole,
    LunarLander,
    MountainCar,
    TimeFractionObs,
    Transition,
)
from deep_q_learning_tpu_torch.envs import lunar_lander
from deep_q_learning_tpu_torch.ops import td_kernels
from deep_q_learning_tpu_torch.replay import PrioritizedReplay, UniformReplay

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "deep_q_learning_tpu"

# JAX name -> (the port's counterpart or None, why)
BY_DESIGN = {
    "ops.build_pallas_loss_fn": ("ops.build_fused_loss_fn", "the kernel is CUDA, not Pallas"),
    "ops.td_kernels.build_pallas_loss_fn": ("ops.td_kernels.build_fused_loss_fn", "as above"),
    "ops.sample_kernels.prioritized_sample_pallas": (
        "ops.sample_kernels.slot_select", "the CUDA slot kernel's wrapper"),
    "utils.checkpoint.haiku_to_flax_params": (
        "utils.checkpoint.haiku_to_torch", "also utils.checkpoint.haiku_to_flax_dict"),
    "compat.host_env.JaxHostEnv": ("compat.host_env.TorchHostEnv", "the port's env engine"),
    "utils.aot": (None, "the AOT cache works around remote TPU compiles"),
    **{f"{mod}.{name}": (None, "the process group is the port's mesh")
       for mod in ("parallel", "parallel.mesh")
       for name in ("make_env_mesh", "env_sharding", "replicated_sharding")},
    **{f"replay.{mod}.{cls}.{name}": (None, "XLA's in-place and sharding plumbing")
       for mod, cls in (("uniform", "UniformReplay"), ("prioritized", "PrioritizedReplay"))
       for name in ("learner_view", "with_learner_view", "shard_specs", "to_local", "to_global")},
}


def _modules():
    """Every module of the JAX package, by its dotted path under it ('' for
    the package itself)."""
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        parts = list(path.relative_to(JAX_PKG).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _public_names(rel: str):
    """``(names, methods)`` of the JAX module at ``rel``, read from its
    source: public top-level defs, classes and assignments (a package's
    re-exports too), and each public class's public methods."""
    path = JAX_PKG.joinpath(*rel.split(".")) if rel else JAX_PKG
    is_pkg = path.is_dir()
    tree = ast.parse((path / "__init__.py" if is_pkg else path.with_suffix(".py")).read_text())
    names, methods = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                methods[node.name] = {n.name for n in node.body if isinstance(n, ast.FunctionDef)
                                      and not n.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif is_pkg and isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "deep_q_learning_tpu"):
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}, methods


def _port_attr(dotted: str):
    """The port's ``<module path>.<name>``."""
    module, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(f"deep_q_learning_tpu_torch.{module}"), name)


@pytest.mark.parametrize("rel", [m for m in _modules() if m not in BY_DESIGN])
def test_public_names_import_from_the_port(rel):
    module = importlib.import_module(
        "deep_q_learning_tpu_torch" + (f".{rel}" if rel else ""))
    names, methods = _public_names(rel)
    missing = []
    for name in sorted(names):
        key = f"{rel}.{name}" if rel else name
        if key in BY_DESIGN:
            continue
        if not hasattr(module, name):
            missing.append(key)
            continue
        for method in sorted(methods.get(name, ())):
            if f"{key}.{method}" not in BY_DESIGN and not hasattr(getattr(module, name), method):
                missing.append(f"{key}.{method}")
    assert not missing, f"missing from the port: {missing}"


def test_by_design_names_have_their_counterparts():
    for port_name, _why in BY_DESIGN.values():
        if port_name is not None:
            assert callable(_port_attr(port_name)), port_name


def test_reexports_are_the_modules_objects_and_leave_matplotlib_out():
    from deep_q_learning_tpu_torch import algos, utils
    from deep_q_learning_tpu_torch.algos import evaluate
    from deep_q_learning_tpu_torch.utils import metrics, visualize

    assert algos.build_evaluator is evaluate.build_evaluator
    for name in ("MetricLogger", "plot_history", "stopwatch", "trace"):
        assert getattr(utils, name) is getattr(metrics, name)
    for name in ("dump_trajectory", "plot_lander_flight", "record_trajectory"):
        assert getattr(utils, name) is getattr(visualize, name)
    assert ops.fused_td_loss is td_kernels.fused_td_loss
    code = ("import sys, deep_q_learning_tpu_torch.utils, deep_q_learning_tpu_torch.ops; "
            "sys.exit(any(m.split('.')[0] == 'matplotlib' for m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ------------------------------------------------------------------ replay


def _port_transition(num_envs, step):
    """``tests/test_replay.py``'s transition: obs encodes (env, step)."""
    base = torch.arange(num_envs, dtype=torch.float32)
    return Transition(
        obs=torch.stack([base, torch.full((num_envs,), float(step))], dim=1),
        action=torch.full((num_envs,), step % 4, dtype=torch.int32),
        reward=torch.full((num_envs,), float(step)),
        next_obs=torch.zeros((num_envs, 2)),
        terminated=torch.zeros((num_envs,), dtype=torch.bool),
        truncated=torch.zeros((num_envs,), dtype=torch.bool),
    )


def _jax_transition(num_envs, step):
    t = _port_transition(num_envs, step)
    return JaxTransition(**{k: jnp.asarray(getattr(t, k).numpy()) for k in
                            ("obs", "action", "reward", "next_obs", "terminated", "truncated")})


def _filled(replay, steps):
    state = replay.init(_port_transition(replay.num_envs, 0))
    for t in range(steps):
        replay.add(state, _port_transition(replay.num_envs, t))
    return state


def test_sample_returns_stored_transitions():
    replay = UniformReplay(num_envs=4, capacity_per_env=8)
    state = _filled(replay, 5)
    batch = replay.sample(state, torch.Generator().manual_seed(0), 64)
    obs = batch.obs.numpy()
    assert ((obs[:, 0] >= 0) & (obs[:, 0] < 4)).all()
    assert ((obs[:, 1] >= 0) & (obs[:, 1] < 5)).all()  # only filled slots
    np.testing.assert_array_equal(batch.reward.numpy(), obs[:, 1])
    assert batch.action.dtype == torch.int32 and batch.terminated.dtype == torch.bool
    np.testing.assert_array_equal(batch.action.numpy(), obs[:, 1].astype(int) % 4)


def test_sample_uniform_coverage():
    replay = UniformReplay(num_envs=2, capacity_per_env=16)
    state = _filled(replay, 16)
    batch = replay.sample(state, torch.Generator().manual_seed(1), 4096)
    counts = np.bincount(batch.reward.numpy().astype(int), minlength=16)
    # with-replacement uniform over 32 cells: each of 16 steps ~256 draws
    assert counts.min() > 150 and counts.max() < 400
    envs = np.bincount(batch.obs[:, 0].numpy().astype(int), minlength=2)
    assert envs.min() > 1800


@pytest.mark.parametrize("steps", [5, 11])  # part filled; wrapped past capacity
def test_sample_gathers_as_jax_on_its_indices(steps):
    n, cap, b = 4, 8, 64
    jreplay = JaxUniformReplay(num_envs=n, capacity_per_env=cap)
    jstate = jreplay.init(_jax_transition(n, 0))
    for t in range(steps):
        jstate = jreplay.add(jstate, _jax_transition(n, t))
    key = jax.random.PRNGKey(steps)
    want = jreplay.sample(jstate, key, b)
    # the indices the JAX sample draws from this key
    env_key, slot_key = jax.random.split(key)
    env_idx = jax.random.randint(env_key, (b,), 0, n)
    slot_idx = jax.random.randint(slot_key, (b,), 0, max(min(steps, cap), 1))

    replay = UniformReplay(num_envs=n, capacity_per_env=cap)
    state = _filled(replay, steps)
    indices = tuple(torch.tensor(np.asarray(i), dtype=torch.int64) for i in (env_idx, slot_idx))
    got = replay.sample(state, None, b, indices=indices)
    for field in ("obs", "action", "reward", "next_obs", "terminated", "truncated"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)


@pytest.mark.parametrize("kind", ["uniform", "prioritized"])
def test_can_sample_gate(kind):
    """``tests/test_replay.py::test_can_sample_gate`` on both replays."""
    replay = (UniformReplay if kind == "uniform" else PrioritizedReplay)(4, 8)
    state = replay.init(_port_transition(4, 0))
    gate = replay.can_sample(state, 8)
    assert gate.dtype == torch.bool and gate.dim() == 0 and not bool(gate)
    replay.add(state, _port_transition(4, 0))
    assert bool(replay.can_sample(state, 4))  # 4 stored: 1 slot x 4 envs
    assert not bool(replay.can_sample(state, 5))
    replay.add(state, _port_transition(4, 1))
    assert bool(replay.can_sample(state, 8))


# -------------------------------------------------------------------- envs


def _envs():
    return [CartPole(), Acrobot(), MountainCar(), LunarLander(), TimeFractionObs(LunarLander())]


def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        for f in a.__dataclass_fields__:
            _assert_trees_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("index", range(5), ids=["cartpole", "acrobot", "mountain_car",
                                                "lander", "time_fraction_lander"])
def test_reset_and_step_are_the_env_functions(index):
    env = _envs()[index]
    params = env.default_params()
    n = 6

    def run(reset, step):
        g = torch.Generator().manual_seed(index)
        obs, state = reset(g, n, params)
        action = torch.arange(n, dtype=torch.int32) % env.num_actions
        return (obs, state), step(g, state, action, params)

    _assert_trees_equal(run(env.reset, env.step), run(env.reset_env, env.step_env))


def test_names_and_lander_constants_match_jax():
    assert LunarLander().name == JaxLunarLander().name == "LunarLander"
    assert TimeFractionObs(LunarLander()).name == JaxTimeFractionObs(JaxLunarLander()).name \
        == "TimeFractionObs(LunarLander)"
    assert [e.name for e in _envs()[:3]] == ["CartPole", "Acrobot", "MountainCar"]
    assert lunar_lander.LEG_H == jax_lander.LEG_H == 8.0 / 30.0
    assert lunar_lander.HULL_MASS == jax_lander.HULL_MASS


# ----------------------------------------------------------- fused_td_loss

ORDER = ("q_s", "q_next_online", "q_next_target", "action", "reward", "bootstrap", "weights")


def _td_inputs(b, a, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(
        q_s=f(b, a), q_next_online=f(b, a), q_next_target=f(b, a),
        action=rng.integers(0, a, b).astype(np.int32),
        reward=f(b), bootstrap=(0.97 * (rng.random(b) > 0.3)).astype(np.float32),
        weights=(np.abs(f(b)) + 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("shape", [(64, 4), (37, 2), (300, 4)])
def test_fused_td_loss_matches_jax(shape, double):
    x = _td_inputs(*shape, seed=shape[0] + int(double))
    args = [jnp.asarray(x[k]) for k in ORDER]
    loss_j, td_j = jax_fused_td_loss(*args, 1.0, double, True)
    dq_j = jax.grad(lambda q: jax_fused_td_loss(q, *args[1:], 1.0, double, True)[0])(args[0])

    q_s, q_no, q_nt, *rest = [torch.from_numpy(x[k].copy()) for k in ORDER]
    q_s.requires_grad_(True)
    q_no.requires_grad_(True)
    q_nt.requires_grad_(True)
    td_kernels.reset_counts()
    loss, td = ops.fused_td_loss(q_s, q_no, q_nt, *rest, delta=1.0, double=double)
    loss.backward()
    assert td_kernels.plain_calls == {"td_loss_fwd": 1, "td_loss_bwd": 1}
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(td_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(q_s.grad.numpy(), np.asarray(dq_j), rtol=1e-4, atol=1e-7)
    assert not td.requires_grad
    assert q_no.grad is None and q_nt.grad is None  # the targets are stopped

"""The port's configuration (``deep_q_learning_tpu_torch/config.py``) against
the JAX package's (``deep_q_learning_tpu/config.py``): the port keeps its
own copy of the schema and presets, and the two must stay equal, field for
field and preset for preset.  Importing the port and its CLI must load no
module of the JAX package and no jax."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from deep_q_learning_tpu import config as jax_config
from deep_q_learning_tpu_torch import config

REPO = Path(__file__).resolve().parents[1]


def _fields(cls):
    return [(f.name, f.default, f.type) for f in dataclasses.fields(cls)]


def test_schema_fields_and_defaults_are_equal():
    assert _fields(config.DQNConfig) == _fields(jax_config.DQNConfig)
    assert config.DQNConfig().capacity_per_env == jax_config.DQNConfig().capacity_per_env
    assert config.DQNConfig().env_param_overrides() == jax_config.DQNConfig().env_param_overrides()


def test_preset_names_are_equal():
    assert list(config.PRESETS) == list(jax_config.PRESETS)


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_preset_is_equal(name):
    ours, theirs = config.PRESETS[name](), jax_config.PRESETS[name]()
    assert config.config_to_dict(ours) == jax_config.config_to_dict(theirs)
    assert ours.capacity_per_env == theirs.capacity_per_env
    assert ours.env_param_overrides() == theirs.env_param_overrides()


@pytest.mark.parametrize("num_envs", [128, 512, 4096])
def test_scaled_presets_are_equal_at_other_env_counts(num_envs):
    for name in ("lunar_per_scaled", "lunar_jointed_scaled"):
        ours = getattr(config, name)(num_envs)
        theirs = getattr(jax_config, name)(num_envs)
        assert config.config_to_dict(ours) == jax_config.config_to_dict(theirs)


def test_shape_affecting_fields_and_mismatches_agree():
    assert config.SHAPE_AFFECTING_FIELDS == jax_config.SHAPE_AFFECTING_FIELDS
    saved = config.config_to_dict(config.lunar_per())
    for field, value in [("batch_size", 512), ("hidden", [64, 64]), ("seed", 9),
                         ("target_tau", None), ("lander_engine", "jointed")]:
        changed = dict(saved, **{field: value})
        ours = config.config_shape_mismatches(changed, config.lunar_per())
        theirs = jax_config.config_shape_mismatches(changed, jax_config.lunar_per())
        assert ours == theirs
        assert (field in ours) == (field != "seed"), (field, ours)


def test_import_loads_nothing_of_the_jax_package():
    code = (
        "import sys, deep_q_learning_tpu_torch, deep_q_learning_tpu_torch.__main__\n"
        "from pathlib import Path\n"
        "jax_pkg = (Path.cwd() / 'deep_q_learning_tpu').resolve()\n"
        "bad = [name for name, m in list(sys.modules.items())\n"
        "       if name.split('.')[0] == 'jax'\n"
        "       or jax_pkg in Path(getattr(m, '__file__', None) or '/').resolve().parents]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr

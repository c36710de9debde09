"""Configuration: the JAX package's ``config.py``, shared by both packages.

There is one schema (``DQNConfig``) and one set of presets.  That module is
pure ``dataclasses``, but importing it as ``deep_q_learning_tpu.config``
would run the JAX package's ``__init__`` too.  So the port executes the same
source file under its own module name: the definitions are the JAX
package's, and importing the port imports nothing of the JAX package.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_NAME = "deep_q_learning_tpu_torch._shared_config"
_SOURCE = Path(__file__).resolve().parents[1] / "deep_q_learning_tpu" / "config.py"


def _load_shared_config():
    if _NAME in sys.modules:
        return sys.modules[_NAME]
    spec = importlib.util.spec_from_file_location(_NAME, _SOURCE)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the shared config from {_SOURCE}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[_NAME] = module  # dataclasses resolve annotations through it
    spec.loader.exec_module(module)
    return module


_shared = _load_shared_config()

DQNConfig = _shared.DQNConfig
PRESETS = _shared.PRESETS
lunar_per = _shared.lunar_per
lunar_per_scaled = _shared.lunar_per_scaled
lunar_jointed_per = _shared.lunar_jointed_per
lunar_jointed_scaled = _shared.lunar_jointed_scaled
config_to_dict = _shared.config_to_dict
config_shape_mismatches = _shared.config_shape_mismatches

__all__ = [
    "DQNConfig", "PRESETS", "lunar_per", "lunar_per_scaled",
    "lunar_jointed_per", "lunar_jointed_scaled",
    "config_to_dict", "config_shape_mismatches",
]

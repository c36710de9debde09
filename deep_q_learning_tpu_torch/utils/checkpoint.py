"""Full-runner checkpoints (``deep_q_learning_tpu/utils/checkpoint.py``).

A checkpoint holds everything the training loop owns, so a resumed run
continues bitwise: online and target weights, optimizer moments and count,
the runtime hyperparameters, env states and observations, the replay ring,
priorities, max priority, cursor and fill, the device generator's state,
and every counter and the return window.

The runner is flattened to plain data before ``torch.save``: nested dicts
and lists of CPU tensors, Python numbers and strings.  ``torch.load`` then
runs with ``weights_only=True``, which unpickles nothing else, so loading a
checkpoint cannot run code and needs no allow-list of the port's classes.
Restoring walks a template runner (a fresh ``init``) beside the saved tree:
each tensor must match its template's shape and dtype and moves to the
template's device; modules load their state dicts; generators take their
saved state (a CPU byte tensor, so the file is read onto the CPU).

Checkpoints are files ``<path>/<step>.pt``.  Each is written to a temporary
name and then renamed into place, so a partly written file is never read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch

_SUFFIX = ".pt"


def _to_tree(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, torch.nn.Module):
        return {k: v.detach().cpu() for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [_to_tree(x) for x in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _from_tree(template: Any, saved: Any, where: str) -> Any:
    """``template`` with the values of ``saved``; raises on any mismatch of
    structure, type, shape or dtype."""
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: expected a tensor, the checkpoint holds {type(saved).__name__}")
        if saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(
                f"{where}: the checkpoint holds {saved.dtype} {tuple(saved.shape)}, "
                f"the trainer {template.dtype} {tuple(template.shape)}"
            )
        return saved.to(template.device)
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(saved)
        return template
    if isinstance(template, torch.Generator):
        template.set_state(saved)
        return template
    if dataclasses.is_dataclass(template):
        names = [f.name for f in dataclasses.fields(template)]
        if not isinstance(saved, dict) or sorted(saved) != sorted(names):
            raise ValueError(f"{where}: the checkpoint's fields differ from {names}")
        return dataclasses.replace(
            template,
            **{n: _from_tree(getattr(template, n), saved[n], f"{where}.{n}") for n in names},
        )
    if isinstance(template, list):
        if not isinstance(saved, list) or len(saved) != len(template):
            raise ValueError(f"{where}: expected a list of {len(template)}")
        return [_from_tree(t, s, f"{where}[{i}]") for i, (t, s) in enumerate(zip(template, saved))]
    if type(saved) is not type(template):
        raise ValueError(
            f"{where}: the checkpoint holds a {type(saved).__name__}, the trainer a "
            f"{type(template).__name__}"
        )
    return saved


def _checkpoint_file(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"{step}{_SUFFIX}")


def save_checkpoint(path: str, runner: Any, step: int) -> str:
    """Save ``runner`` as ``path/<step>.pt``; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    final = _checkpoint_file(path, step)
    tmp = f"{final}.tmp-{os.getpid()}"
    torch.save(_to_tree(runner), tmp)
    os.replace(tmp, final)
    return final


def restore_checkpoint(path: str, template_runner: Any, step: Optional[int] = None) -> Any:
    """The runner saved at ``path/<step>.pt`` (the latest step if None),
    rebuilt on the structure and devices of ``template_runner``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    saved = torch.load(_checkpoint_file(path, step), map_location="cpu", weights_only=True)
    return _from_tree(template_runner, saved, "runner")


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [
        int(name[: -len(_SUFFIX)]) for name in os.listdir(path)
        if name.endswith(_SUFFIX) and name[: -len(_SUFFIX)].isdigit()
    ]
    return max(steps) if steps else None

"""Full-runner checkpoints (``deep_q_learning_tpu/utils/checkpoint.py``).

A checkpoint holds everything the training loop owns, so a resumed run
continues bitwise: online and target weights, optimizer moments and count,
the runtime hyperparameters, env states and observations, the replay ring,
priorities, max priority, cursor and fill, the device generator's state,
and every counter and the return window.

A counter that the learner's CUDA graphs advance on the device (the Adam
count, one a member in a population; the replay's cursor and fill; the
runner's frame count, on which a superstep's graph decides its syncs) is
a host int mirrored by a device tensor (``envs/graphed.py::device_mirror``).
The checkpoint holds the int, read back from the tensor at save time and
checked against the mirror; a restore writes it into both.

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

A run over ranks (``train.DistributedTrainer``) checkpoints into a step
directory ``<path>/<step>/``: ``learner.pt``, the replicated learner,
written once (by rank 0), and ``shard_<rank>.pt``, the rest of each
rank's runner (its envs, replay, generator, counters and window).

The reference's on-disk format, a pickle pair ``<dir>/params.pickle`` and
``<dir>/opt_state.pickle``, is written and read at the end of this module.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
from typing import Any, Optional, Tuple

import numpy as np
import torch

_SUFFIX = ".pt"


def _mirrors(obj: Any) -> dict:
    """``{host field: device field}`` of a dataclass's mirrored counters."""
    return {f.name: f.metadata["device"] for f in dataclasses.fields(obj) if "device" in f.metadata}


def _read_counter(obj: Any, host: str, device: str) -> Any:
    """The counter's value on the device (the host int where there is no
    device tensor; a list of ints, one a member, for a population's);
    raises where the two differ."""
    value, tensor = getattr(obj, host), getattr(obj, device)
    if tensor is not None and tensor.tolist() != value:
        raise RuntimeError(f"{type(obj).__name__}.{device} holds {tensor.tolist()} on the device "
                           f"but its host mirror {host} is {value}")
    return value


def _to_tree(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, torch.nn.Module):
        return {k: v.detach().cpu() for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if dataclasses.is_dataclass(obj):
        mirrors = _mirrors(obj)
        return {f.name: _read_counter(obj, f.name, mirrors[f.name]) if f.name in mirrors
                else _to_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name not in mirrors.values()}
    if isinstance(obj, list):
        return [_to_tree(x) for x in obj]
    if type(obj) is tuple:  # a population's cadences
        return tuple(_to_tree(x) for x in obj)
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
        mirrors = _mirrors(template)
        names = [f.name for f in dataclasses.fields(template) if f.name not in mirrors.values()]
        if not isinstance(saved, dict) or sorted(saved) != sorted(names):
            raise ValueError(f"{where}: the checkpoint's fields differ from {names}")
        values = {n: _from_tree(getattr(template, n), saved[n], f"{where}.{n}") for n in names}
        for host, dev in mirrors.items():
            tensor = getattr(template, dev)
            if tensor is not None:
                values[dev] = torch.tensor(values[host], dtype=tensor.dtype, device=tensor.device)
        return dataclasses.replace(template, **values)
    if isinstance(template, list) or type(template) is tuple:
        kind = list if isinstance(template, list) else tuple
        if not isinstance(saved, kind) or len(saved) != len(template):
            raise ValueError(f"{where}: expected a {kind.__name__} of {len(template)}")
        return kind(_from_tree(t, s, f"{where}[{i}]") for i, (t, s) in enumerate(zip(template, saved)))
    if type(saved) is not type(template):
        raise ValueError(
            f"{where}: the checkpoint holds a {type(saved).__name__}, the trainer a "
            f"{type(template).__name__}"
        )
    return saved


def _checkpoint_file(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"{step}{_SUFFIX}")


def _save_atomic(tree: Any, final: str) -> str:
    tmp = f"{final}.tmp-{os.getpid()}"
    torch.save(tree, tmp)
    os.replace(tmp, final)
    return final


def save_checkpoint(path: str, runner: Any, step: int) -> str:
    """Save ``runner`` as ``path/<step>.pt``; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    return _save_atomic(_to_tree(runner), _checkpoint_file(path, step))


def restore_checkpoint(path: str, template_runner: Any, step: Optional[int] = None) -> Any:
    """The runner saved at ``path/<step>.pt`` (the latest step if None),
    rebuilt on the structure and devices of ``template_runner``."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    saved = torch.load(_checkpoint_file(path, step), map_location="cpu", weights_only=True)
    return _from_tree(template_runner, saved, "runner")


def _steps(path: str) -> list:
    if not os.path.isdir(path):
        return []
    return sorted(
        int(name[: -len(_SUFFIX)]) for name in os.listdir(path)
        if name.endswith(_SUFFIX) and name[: -len(_SUFFIX)].isdigit()
    )


def latest_step(path: str) -> Optional[int]:
    steps = _steps(path)
    return steps[-1] if steps else None


def prune_checkpoints(path: str) -> None:
    """Delete every checkpoint under ``path`` but the newest."""
    for step in _steps(path)[:-1]:
        os.remove(_checkpoint_file(path, step))


# ---------------------------------------------------------------------------
# A run over ranks: one step directory, the learner once, a shard a rank
# ---------------------------------------------------------------------------

_LEARNER = "learner.pt"


def _shard_name(shard: int) -> str:
    return f"shard_{shard}.pt"


def save_sharded_checkpoint(path: str, runner: Any, step: int, shard: int) -> str:
    """Save this rank's part of a run over ranks under ``path/<step>/``:
    ``learner.pt`` from shard 0 (the learner is the same on every rank) and
    ``shard_<shard>.pt``, the rest of the runner.  Returns the directory.
    The caller waits for every rank before reading it back."""
    step_dir = os.path.join(os.path.abspath(path), str(step))
    os.makedirs(step_dir, exist_ok=True)
    if shard == 0:
        _save_atomic(_to_tree(runner.train), os.path.join(step_dir, _LEARNER))
    rest = dataclasses.replace(runner, train=None)
    _save_atomic(_to_tree(rest), os.path.join(step_dir, _shard_name(shard)))
    return step_dir


def restore_sharded_checkpoint(
    path: str, template_runner: Any, shard: int, step: Optional[int] = None
) -> Any:
    """This rank's runner from ``path/<step>/`` (the latest step if None):
    the shared learner and the rank's own shard, rebuilt on the structure
    and devices of ``template_runner``."""
    if step is None:
        step = latest_sharded_step(path)
        if step is None:
            raise FileNotFoundError(f"no sharded checkpoints under {path}")
    step_dir = os.path.join(os.path.abspath(path), str(step))
    shard_file = os.path.join(step_dir, _shard_name(shard))
    if not os.path.exists(shard_file):
        raise FileNotFoundError(f"{shard_file} is missing: the checkpoint has no shard {shard}")
    load = lambda f: torch.load(f, map_location="cpu", weights_only=True)  # noqa: E731
    rest = _from_tree(dataclasses.replace(template_runner, train=None), load(shard_file), "runner")
    train = _from_tree(template_runner.train, load(os.path.join(step_dir, _LEARNER)), "runner.train")
    return dataclasses.replace(rest, train=train)


def latest_sharded_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(name) for name in os.listdir(path)
             if name.isdigit() and os.path.isdir(os.path.join(path, name))]
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# The reference's pickle pair (params.pickle, opt_state.pickle)
# ---------------------------------------------------------------------------
#
# ``params`` is a flax ``QNetwork`` parameter dict of numpy arrays
# (``{"params": {"trunk_0": {"kernel", "bias"}, ...}}``); ``opt_state`` is
# the state of ``optax.chain(clip_by_global_norm(m), <optimizer>(lr))`` (the
# clip's entry only when the config clips), whose nodes are optax's state
# classes.  The port may not import optax, so the local classes below stand
# in for them: reading maps optax's names onto them, and writing writes
# optax's names, so that a program with optax reads back optax's classes.


class _OptaxState:
    """Marks a stand-in for an optax state class: ``_optax_name`` is the
    ``(module, name)`` the pickle refers to."""

    _optax_name: Tuple[str, str]


class EmptyState(collections.namedtuple("EmptyState", []), _OptaxState):
    __slots__ = ()
    _optax_name = ("optax._src.base", "EmptyState")


class ScaleByAdamState(collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"]),
                       _OptaxState):
    __slots__ = ()
    _optax_name = ("optax._src.transform", "ScaleByAdamState")


class ScaleByRmsState(collections.namedtuple("ScaleByRmsState", ["nu"]), _OptaxState):
    __slots__ = ()
    _optax_name = ("optax._src.transform", "ScaleByRmsState")


_OPTAX_CLASSES = {cls._optax_name: cls for cls in (EmptyState, ScaleByAdamState, ScaleByRmsState)}


def _reconstruct_legacy_device_array(fun, args, arr_state=None, aval_state=None):
    """A jax-0.3-era ``DeviceArray`` pickle payload, as numpy: jax 0.3's
    ``reconstruct_device_array(fun, args, arr_state, aval_state)`` rebuilt
    the numpy value and then put it on a device; this stops at the value."""
    value = fun(*args)
    if arr_state is not None:
        value.__setstate__(arr_state)
    return np.asarray(value)


class _ReferenceUnpickler(pickle.Unpickler):
    """Reads pickles written by the reference's jax/haiku/optax stacks and
    by this module, and refuses any other class.

    The jax-0.3 ``DeviceArray`` reconstructors (modules that modern jax
    deleted) become numpy arrays, haiku's ``FlatMap`` and its immutable
    dicts become dicts, and optax's state classes become the stand-ins
    above."""

    _DEVICE_ARRAY_FNS = {
        ("jax._src.device_array", "reconstruct_device_array"),
        ("jax.interpreters.xla", "reconstruct_device_array"),
        ("jax.interpreters.xla", "_reconstruct_device_array"),
    }
    _NUMPY = {
        ("numpy._core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"), ("numpy.core.multiarray", "scalar"),
        ("numpy", "ndarray"), ("numpy", "dtype"),
    }

    def find_class(self, module, name):
        if (module, name) in self._DEVICE_ARRAY_FNS:
            return _reconstruct_legacy_device_array
        if module.startswith("haiku") and name in ("FlatMap", "FlatMapping", "frozendict"):
            return dict
        if (module, name) in _OPTAX_CLASSES:
            return _OPTAX_CLASSES[(module, name)]
        if (module, name) in self._NUMPY or (module, name) == ("collections", "OrderedDict"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name} from a reference pickle")


class _ReferencePickler(pickle._Pickler):
    """Writes the stand-ins under optax's class names (the C pickler looks
    a class up by its own module, so this is the Python one)."""

    def save_global(self, obj, name=None):
        if isinstance(obj, type) and issubclass(obj, _OptaxState):
            module, qualname = obj._optax_name
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def save_params_pickle(directory: str, params: Any, opt_state: Any) -> None:
    """Write ``params.pickle`` and ``opt_state.pickle`` (protocol 4), each
    to a temporary name renamed into place."""
    os.makedirs(directory, exist_ok=True)
    for name, tree in (("params.pickle", params), ("opt_state.pickle", opt_state)):
        final = os.path.join(directory, name)
        tmp = f"{final}.tmp-{os.getpid()}"
        with open(tmp, "wb") as f:
            _ReferencePickler(f, protocol=4).dump(tree)
        os.replace(tmp, final)


def load_params_pickle(directory: str):
    """``(params, opt_state)`` from the reference's pickle pair, with numpy
    leaves, including the reference's jax-0.3-era pickles."""
    out = []
    for name in ("params.pickle", "opt_state.pickle"):
        with open(os.path.join(directory, name), "rb") as f:
            out.append(_ReferenceUnpickler(f).load())
    return tuple(out)


def _flax_tree(network, tensors) -> dict:
    """``tensors`` (one per ``network.parameters()``, in order) as a flax
    ``QNetwork`` parameter dict of numpy arrays; weights become kernels."""
    index = {id(p): i for i, p in enumerate(network.parameters())}
    as_np = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    return {"params": {
        name: {"kernel": as_np(tensors[index[id(layer.weight)]]).T.copy(),
               "bias": as_np(tensors[index[id(layer.bias)]])}
        for name, layer in network.flax_layers()
    }}


def to_reference_format(train_state, optimizer) -> Tuple[dict, tuple]:
    """``(params, opt_state)`` of a single learner in the reference's format:
    the online network's flax dict and the optax chain's state, whose
    moments are flax dicts too."""
    online, state = train_state.online, train_state.opt_state
    params = _flax_tree(online, list(online.parameters()))
    if optimizer.name in ("adam", "adamw"):
        adam = ScaleByAdamState(
            np.asarray(state.count, np.int32), _flax_tree(online, state.mu),
            _flax_tree(online, state.nu),
        )
        inner = (adam, EmptyState()) + ((EmptyState(),) if optimizer.name == "adamw" else ())
    elif optimizer.name == "rmsprop":
        inner = (ScaleByRmsState(_flax_tree(online, state.nu)), EmptyState(), EmptyState())
    else:  # sgd
        inner = (EmptyState(), EmptyState())
    return params, ((EmptyState(), inner) if optimizer.clip else inner)


def haiku_to_flax_dict(hk_params, hidden_layers: int) -> dict:
    """A reference (Haiku) ``Model`` parameter dict as a flax ``QNetwork``
    dict of numpy arrays.  Haiku names the layers ``model/~/linear``,
    ``linear_1``, ... in creation order: the ``hidden_layers`` trunk layers,
    then the head (for a dueling net, the 1-wide value head and the
    advantage head, in either order)."""

    def _index(key: str) -> int:
        tail = key.rsplit("linear", 1)[-1]
        return int(tail.lstrip("_")) if tail else 0

    layers = sorted((k for k in hk_params if "linear" in k.rsplit("/", 1)[-1]), key=_index)
    dense = lambda k: {"kernel": np.asarray(hk_params[k]["w"]),  # noqa: E731
                       "bias": np.asarray(hk_params[k]["b"])}
    out = {f"trunk_{i}": dense(k) for i, k in enumerate(layers[:hidden_layers])}
    heads = layers[hidden_layers:]
    if len(heads) == 1:
        out["q"] = dense(heads[0])
    else:
        h0, h1 = heads
        val_k, adv_k = (h0, h1) if np.shape(hk_params[h0]["w"])[-1] == 1 else (h1, h0)
        out["value"], out["advantage"] = dense(val_k), dense(adv_k)
    return {"params": out}


def haiku_to_torch(hk_params, hidden_layers: int, device=None):
    """A reference (Haiku) parameter dict as the port's ``QNetwork``."""
    from deep_q_learning_tpu_torch.models import QNetwork

    return QNetwork.from_flax_params(haiku_to_flax_dict(hk_params, hidden_layers), device=device)

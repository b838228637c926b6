"""Streaming-state transfer and checkpoints for the port; counterpart of
``radiocore_tpu/runtime/checkpoint.py``.

The state is a dict of tensors with the JAX package's keys (``deemph_l``,
``deemph_r``), whose entries may be named tuples of tensors (``pll``, a
``PLLState``). :func:`save_state` writes and :func:`load_state` reads the
npz layout of the JAX package's ``save_state``, so a stream saved by
either package resumes in the other: an entry is keyed by its whole tree
path, ``"['deemph_l']"`` for a dict entry and ``"['pll']/.phase"`` for a
field of a named tuple inside it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.ops.nco_pll import PLLState

State = Dict[str, Any]

# A named tuple that comes in from elsewhere (the JAX package's state)
# leaves as the port's own type of the same name.
_PORT_TUPLES = {"PLLState": PLLState}


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _map(tree: Any, fn: Callable[[str, Any], Any],
         path: Tuple[str, ...] = ()) -> Any:
    """A tree of the same structure with ``fn(npz key, leaf)`` for every
    leaf. The key is the leaf's tree path as ``jax.tree_util`` prints it:
    ``['name']`` for a dict entry, ``.field`` for a named tuple's, ``[i]``
    for a sequence's, joined by ``/``."""
    if isinstance(tree, Mapping):
        return {name: _map(v, fn, path + (f"[{name!r}]",))
                for name, v in tree.items()}
    if _is_namedtuple(tree):
        cls = _PORT_TUPLES.get(type(tree).__name__, type(tree))
        return cls(*(_map(getattr(tree, name), fn, path + (f".{name}",))
                     for name in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(item, fn, path + (f"[{i}]",))
                          for i, item in enumerate(tree))
    return fn("/".join(path), tree)


def _flatten(state: Any) -> Dict[str, Any]:
    """``{npz key: leaf}`` of every leaf of ``state``."""
    flat: Dict[str, Any] = {}
    _map(state, flat.__setitem__)
    return flat


def state_from_numpy(state: Any, device: torch.device | str) -> State:
    """A state of NumPy (e.g. JAX) arrays, flat or nested → tensors on
    ``device``, the structure kept."""
    return _map(state, lambda _, v: torch.from_numpy(
        np.array(v, copy=True)).to(device))


def state_to_numpy(state: Any) -> Dict[str, Any]:
    """A state of tensors on any device → NumPy arrays, the structure
    kept."""
    return _map(state, lambda _, v: v.detach().cpu().numpy())


def save_state(path: str, state: Any) -> None:
    """Serialize a state to ``path`` (npz), keyed by tree paths."""
    np.savez(path, **{key: leaf.detach().cpu().numpy()
                      for key, leaf in _flatten(state).items()})


def load_state(path: str, like: Any) -> State:
    """Load a state saved by :func:`save_state` of either package.

    ``like`` gives the structure, shapes, dtypes and devices (e.g. a
    freshly initialized state); a missing entry or a shape mismatch
    raises.
    """
    with np.load(path) as data:
        def leaf(key: str, ref: torch.Tensor) -> torch.Tensor:
            if key not in data:
                raise KeyError(f"checkpoint missing state entry {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint entry {key!r} shape "
                                 f"{arr.shape} != {tuple(ref.shape)}")
            return torch.from_numpy(arr).to(device=ref.device,
                                            dtype=ref.dtype)
        return _map(like, leaf)

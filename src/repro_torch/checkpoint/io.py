"""Checkpoints of the port's states, in the JAX package's format: an
``arrays.npz`` payload and a ``manifest.json`` (version 1) that names each
leaf by its path, shape and logical dtype. A checkpoint written by either
package restores into the other.

A state is a tree of NamedTuples, dicts, lists or tuples, tensors, Python
ints and None. Leaves are visited as ``jax.tree_util`` visits a pytree —
NamedTuple fields in order, dict keys sorted, None no leaf — and each path
is its keys in ``jax.tree_util.keystr``'s pieces joined by "/": ``.name``
for a field, ``['k']`` for a dict key, ``[i]`` for an index. So an engine
state's paths read ``.step``, ``.params/['w1']``,
``.comm/.extras/['momenta']``, as the reference writes them.

A Python int (the step, an optimizer's count; 0-d int32 leaves in the
reference) is saved as an int32 0-d array and restored to an int. A bf16
leaf is stored widened to fp32 (npz has no bf16) under its logical dtype
``bfloat16``, and restored by rounding to nearest even, which is exact
for a value that was bf16.

A cohort plane's host ``WorkerPool`` rides as ordinary leaves
(``{"pool": pool.state_dict()}``): its (M, n_flat) planes reshard through
:func:`_reshard_flat` like any flat worker plane, bf16 planes are widened
in the file, and ``pool.load_state_dict`` writes the restored planes in
place, so a memmap pool stays mapped.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device

# torch dtype -> the manifest's (numpy) dtype name
_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree, prefix=()):
    """(paths, leaves) of a state, in ``jax.tree_util``'s order and with
    its key strings."""
    if tree is None:
        return [], []
    if _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return ["/".join(prefix)], [tree]
    paths, leaves = [], []
    for key, sub in items:
        p, l = _flatten_with_paths(sub, prefix + (key,))
        paths += p
        leaves += l
    return paths, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _logical_dtype(leaf) -> str:
    """The manifest's dtype name of a leaf: a tensor's, or int32 for a
    Python int (the reference's 0-d int32 step and counts)."""
    if torch.is_tensor(leaf):
        name = _DTYPE_NAMES.get(leaf.dtype)
        if name is None:
            raise TypeError(f"cannot checkpoint a {leaf.dtype} tensor")
        return name
    if isinstance(leaf, int):
        return "int32"
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _to_numpy(leaf) -> np.ndarray:
    """The stored array of a leaf: bf16 widened to fp32 (exact), an int as
    an int32 0-d array."""
    if not torch.is_tensor(leaf):
        return np.asarray(leaf, np.int32)
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(path: str, tree: Any, step: int | None = None,
         flat_meta: Any = None) -> None:
    """Write ``tree`` to the directory ``path``. ``flat_meta`` (a
    ``core.flat.FlatLayout`` or a ``{"n", "n_flat"}`` dict) records the
    flat plane's layout, so :func:`restore` can re-cut a plane's zero
    padding tail into a target with another ``n_flat``."""
    os.makedirs(path, exist_ok=True)
    paths, leaves = _flatten_with_paths(tree)
    dtypes = [_logical_dtype(x) for x in leaves]
    stored = [_to_numpy(x) for x in leaves]
    np.savez(os.path.join(path, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(stored)})
    manifest = {
        "version": 1,
        "step": step,
        "paths": paths,
        "shapes": [list(a.shape) for a in stored],
        "dtypes": dtypes,
    }
    if flat_meta is not None:
        get = (flat_meta.get if isinstance(flat_meta, dict)
               else lambda k: getattr(flat_meta, k))
        manifest["flat"] = {"n": int(get("n")), "n_flat": int(get("n_flat"))}
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if torch.is_tensor(leaf) else ()


def _reshard_flat(a: np.ndarray, ref_shape: tuple, flat: dict | None,
                  path: str) -> np.ndarray:
    """A flat-plane leaf saved with one padded ``n_flat`` re-cut to the
    target's last dim: the true ``n`` entries kept, the zero padding tail
    re-cut. Raises, naming the plane, when the mismatch is not a pure
    padding change."""
    if (flat and a.ndim >= 1 and a.shape[:-1] == ref_shape[:-1]
            and a.shape[-1] == flat["n_flat"]):
        n = int(flat["n"])
        new_flat = int(ref_shape[-1])
        if new_flat < n:
            raise ValueError(
                f"flat-plane layout mismatch at {path}: checkpoint holds "
                f"n={n} true entries (n_flat={flat['n_flat']}), restore "
                f"target plane has only {new_flat} lanes")
        tail = a[..., n:]
        if tail.size and np.any(tail != 0):
            raise ValueError(
                f"flat-plane layout mismatch at {path}: padding tail "
                f"beyond n={n} is not zero — the leaf is not a plane of "
                f"the recorded flat layout")
        pad = [(0, 0)] * (a.ndim - 1) + [(0, new_flat - n)]
        return np.pad(a[..., :n], pad)
    raise ValueError(f"shape mismatch at {path}: {a.shape} vs {ref_shape}")


def _to_leaf(a: np.ndarray, like_leaf, device):
    """The stored array as ``like_leaf``'s kind: an int for an int, else a
    tensor of the logical dtype on ``device`` (bf16 narrowed from its fp32
    storage by rounding to nearest even)."""
    if not torch.is_tensor(like_leaf):
        return int(a)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device if device is not None else like_leaf.device,
                dtype=like_leaf.dtype)


def restore(path: str, like: Any, device=None,
            device_put_fn: Callable[[str, np.ndarray], Any] | None = None
            ) -> tuple[Any, int | None]:
    """Restore into the structure of ``like``; returns (state, step).

    Each leaf must have ``like``'s path, shape and logical dtype, else this
    raises and names the leaf: a checkpoint saved under one dtype policy
    (fp32 moments) never narrows silently into another (bf16). A flat
    plane saved with ``flat_meta`` restores into a target with another
    padded ``n_flat`` (the true entries kept, the zero tail re-cut). Each
    tensor goes to ``device`` if given, else to ``like``'s leaf's device.

    ``device_put_fn(path, array)`` (the reference's hook), if given, makes
    each leaf instead: it gets the leaf's path string and the array as the
    file holds it (after the re-cut above; a bf16 leaf widened to fp32),
    and returns the leaf, for example a rank's slice of a flat plane on
    its device (``FlatSharding.cut_server``).
    """
    if device is not None:
        device = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    paths, leaves = _flatten_with_paths(like)
    if paths != manifest["paths"]:
        raise ValueError(
            "checkpoint tree mismatch:\n saved: "
            f"{manifest['paths'][:5]}...\n expected: {paths[:5]}...")
    saved_dtypes = manifest.get("dtypes")
    out = []
    for i, (p, ref) in enumerate(zip(paths, leaves)):
        a = data[f"leaf_{i}"]
        ref_shape = _shape(ref)
        if tuple(a.shape) != ref_shape:
            a = _reshard_flat(a, ref_shape, manifest.get("flat"), p)
        ref_dtype = _logical_dtype(ref)
        if saved_dtypes is not None and saved_dtypes[i] != ref_dtype:
            raise ValueError(
                f"dtype mismatch at {p}: checkpoint holds "
                f"{saved_dtypes[i]}, restore target expects {ref_dtype}")
        out.append(device_put_fn(p, a) if device_put_fn
                   else _to_leaf(a, ref, device))
    return _unflatten(like, iter(out)), manifest["step"]


def latest_step_dir(root: str) -> str | None:
    """The ``step_<k>`` directory under ``root`` with the largest k, or
    None."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=lambda s: int(s.split("_")[1])))

"""Committed checkpoints: a flat npz of leaves + a manifest, async writes,
exact restore.

The port of `repro.ckpt.checkpoint`, with the same on-disk form, so a
checkpoint written by either package restores in the other::

    step_000123/
        arrays.npz      — flat {"0": leaf 0, "1": leaf 1, ...}
        manifest.json   — step, treedef (null here), paths, shapes,
                          dtypes, extras
        COMMITTED       — written last; a step is visible only with it

A step is written into ``step_XXXXXXXX.tmp`` and renamed into place, so a
crashed writer never leaves a half-visible checkpoint.

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
tensors (copied to the host) or scalars. It is flattened in the JAX
package's order: dict keys sorted, sequences in order, depth first; the
manifest's ``paths`` spell each leaf's key path the way that package
does. The reference's ``shardings=`` restore (elastic resharding onto a
device mesh) has no counterpart on one card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, path=()):
    """(path, leaf) pairs in the JAX package's flatten order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (f"DictKey(key={key!r})",))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, path + (f"SequenceKey(idx={i})",))
    else:
        yield path, tree


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _path_str(path) -> str:
    return "(" + ", ".join(path) + ("," if len(path) == 1 else "") + ")"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        # a copy on the CPU too: the train step writes its state in place
        # while an asynchronous write may still be reading the tree
        return leaf.numpy().copy() if leaf.device.type == "cpu" \
            else leaf.cpu().numpy()
    return np.asarray(leaf)


def tree_to_host(tree):
    """`tree` with every leaf a host numpy array (tensors copied off their
    device)."""
    if isinstance(tree, dict):
        return {key: tree_to_host(sub) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_host(sub) for sub in tree)
    return _to_host(tree)


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    extras: dict | None = None, async_write: bool = False):
    """Write `tree` as committed step `step` under `ckpt_dir`.

    With ``async_write=True`` the host copy happens on the calling thread
    and the disk write on a daemon thread, which is returned (join it with
    `wait_for_async`); otherwise the write is done on return."""
    host_tree = tree_to_host(tree)

    def write():
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        flat = list(_flatten(host_tree))
        leaves = [leaf for _, leaf in flat]
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{str(i): leaf for i, leaf in enumerate(leaves)})
        manifest = {
            "step": step,
            "treedef": None,
            "paths": [_path_str(p) for p, _ in flat],
            "shapes": [list(leaf.shape) for leaf in leaves],
            "dtypes": [str(leaf.dtype) for leaf in leaves],
            "extras": extras or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        open(os.path.join(tmp, "COMMITTED"), "w").close()
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str) -> int | None:
    """Highest committed step under `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like_tree):
    """Restore step `step` into the structure of `like_tree`; returns
    ``(tree of numpy arrays, extras)``.

    Every leaf is validated against `like_tree` (count, shape and dtype)
    and the arrays.npz payload is cross-checked against the manifest, so
    a stale, truncated or hand-edited checkpoint raises a descriptive
    `FileNotFoundError` / `ValueError` instead of restoring garbage —
    `repro_torch.api.store` relies on this contract.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(
            f"no committed checkpoint at {path} (missing COMMITTED marker)")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = [leaf for _, leaf in _flatten(like_tree)]
    names = manifest.get("paths") or []

    def leaf_name(i):
        return names[i] if i < len(names) else f"leaf {i}"

    m_shapes = manifest.get("shapes")
    m_dtypes = manifest.get("dtypes")
    loaded = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint {path} holds {len(data.files)} arrays but "
                f"like_tree has {len(leaves)} leaves — stale or truncated "
                f"checkpoint, or a mismatched restore target")
        if m_shapes is not None and len(m_shapes) != len(leaves):
            raise ValueError(
                f"checkpoint manifest {path} records {len(m_shapes)} leaves "
                f"but like_tree has {len(leaves)} — stale or truncated "
                f"manifest")
        for i, want in enumerate(leaves):
            if str(i) not in data.files:
                raise ValueError(f"checkpoint {path} is missing array {i} "
                                 f"({leaf_name(i)}) — truncated arrays.npz")
            got = data[str(i)]
            want = _to_host(want)
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint {path}, {leaf_name(i)}: stored shape "
                    f"{tuple(got.shape)} != expected {tuple(want.shape)}")
            if got.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint {path}, {leaf_name(i)}: stored dtype "
                    f"{got.dtype} != expected {want.dtype}")
            if m_shapes is not None and \
                    tuple(m_shapes[i]) != tuple(got.shape):
                raise ValueError(
                    f"checkpoint {path}, {leaf_name(i)}: manifest shape "
                    f"{tuple(m_shapes[i])} != stored {tuple(got.shape)} — "
                    f"manifest and arrays.npz disagree (partial overwrite?)")
            if m_dtypes is not None and i < len(m_dtypes) and \
                    np.dtype(m_dtypes[i]) != got.dtype:
                raise ValueError(
                    f"checkpoint {path}, {leaf_name(i)}: manifest dtype "
                    f"{m_dtypes[i]} != stored {got.dtype} — manifest and "
                    f"arrays.npz disagree (partial overwrite?)")
            loaded.append(got)
    return _unflatten(like_tree, iter(loaded)), manifest["extras"]


def wait_for_async(thread) -> None:
    """Join the writer thread of an ``async_write=True`` save (no-op for
    None)."""
    if thread is not None:
        thread.join()

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
does. A bf16 leaf is written as its raw 2-byte bits (npz dtype ``|V2``,
manifest dtype ``"bfloat16"``), as that package writes one, and comes
back as those bits (`BF16_BITS`); no ``ml_dtypes`` is needed. The
reference's ``shardings=`` restore (elastic resharding onto a
device mesh) has no counterpart on one card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

#: the npz dtype of a bf16 leaf's bits.
BF16_BITS = np.dtype("V2")


def _flatten(tree) -> list:
    """(path, leaf) pairs in the JAX package's flatten order: depth first,
    walked with an explicit stack."""
    out, stack = [], [((), tree)]
    while stack:
        path, node = stack.pop()
        if isinstance(node, dict):
            subs = [(path + (f"DictKey(key={key!r})",), node[key])
                    for key in sorted(node)]
        elif isinstance(node, (list, tuple)):
            subs = [(path + (f"SequenceKey(idx={i})",), sub)
                    for i, sub in enumerate(node)]
        else:
            out.append((path, node))
            continue
        stack.extend(reversed(subs))
    return out


def _rebuild(like, fn):
    """`like`'s structure (dicts, lists, tuples) with each leaf replaced
    by ``fn(leaf)``, called in `_flatten`'s order; walked with an explicit
    stack."""
    root: list = [None]
    # (node, the container to put its copy in, the key there)
    stack = [(like, root, 0)]
    pending = []            # sequences, filled in as lists, then converted
    while stack:
        node, parent, key = stack.pop()
        if isinstance(node, dict):
            parent[key] = dict.fromkeys(node)
            stack.extend((node[k], parent[key], k)
                         for k in reversed(sorted(node)))
        elif isinstance(node, (list, tuple)):
            parent[key] = [None] * len(node)
            pending.append((type(node), parent, key))
            stack.extend((sub, parent[key], i)
                         for i, sub in reversed(list(enumerate(node))))
        else:
            parent[key] = fn(node)
    for kind, parent, key in reversed(pending):     # innermost first
        if kind is not list:
            parent[key] = kind(parent[key])
    return root[0]


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    return _rebuild(like, lambda _: next(leaves))


def _path_str(path) -> str:
    return "(" + ", ".join(path) + ("," if len(path) == 1 else "") + ")"


def to_host(leaf) -> np.ndarray:
    """A host numpy copy of `leaf` (a tensor, bf16 as its bits; or
    anything numpy takes, as is)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        bf16 = leaf.dtype == torch.bfloat16
        if bf16:
            leaf = leaf.view(torch.int16)
        # a copy on the CPU too: the train step writes its state in place
        # while an asynchronous write may still be reading the tree
        host = leaf.numpy().copy() if leaf.device.type == "cpu" \
            else leaf.cpu().numpy()
        return host.view(BF16_BITS) if bf16 else host
    return np.asarray(leaf)


def dtype_name(dtype) -> str:
    """The manifest's name of a leaf dtype (numpy's or torch's): the bf16
    bits and bf16 itself are ``"bfloat16"``."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return "bfloat16"
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    dtype = np.dtype(dtype)
    return "bfloat16" if dtype == BF16_BITS else str(dtype)


def _shape_dtype(leaf) -> tuple[tuple, str]:
    """(shape, dtype name) of a like-tree leaf, without copying it."""
    if not isinstance(leaf, (torch.Tensor, np.ndarray)):
        leaf = np.asarray(leaf)
    return tuple(leaf.shape), dtype_name(leaf.dtype)


def tree_to_host(tree):
    """`tree` with every leaf a host numpy array (tensors copied off their
    device; bf16 as its bits, `BF16_BITS`)."""
    return _rebuild(tree, to_host)


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
        flat = _flatten(host_tree)
        leaves = [leaf for _, leaf in flat]
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{str(i): leaf for i, leaf in enumerate(leaves)})
        manifest = {
            "step": step,
            "treedef": None,
            "paths": [_path_str(p) for p, _ in flat],
            "shapes": [list(leaf.shape) for leaf in leaves],
            "dtypes": [dtype_name(leaf.dtype) for leaf in leaves],
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
            want_shape, want_dtype = _shape_dtype(want)
            m_dtype = m_dtypes[i] if m_dtypes is not None and \
                i < len(m_dtypes) else None
            # 2-byte voids are bf16 bits only where the manifest says so
            stored = "bfloat16" if got.dtype == BF16_BITS and \
                m_dtype == "bfloat16" else str(got.dtype)
            if tuple(got.shape) != want_shape:
                raise ValueError(
                    f"checkpoint {path}, {leaf_name(i)}: stored shape "
                    f"{tuple(got.shape)} != expected {want_shape}")
            if stored != want_dtype:
                raise ValueError(
                    f"checkpoint {path}, {leaf_name(i)}: stored dtype "
                    f"{got.dtype} != expected {want_dtype}")
            if m_shapes is not None and \
                    tuple(m_shapes[i]) != tuple(got.shape):
                raise ValueError(
                    f"checkpoint {path}, {leaf_name(i)}: manifest shape "
                    f"{tuple(m_shapes[i])} != stored {tuple(got.shape)} — "
                    f"manifest and arrays.npz disagree (partial overwrite?)")
            if m_dtype is not None and m_dtype != stored and (
                    m_dtype == "bfloat16" or np.dtype(m_dtype) != got.dtype):
                raise ValueError(
                    f"checkpoint {path}, {leaf_name(i)}: manifest dtype "
                    f"{m_dtype} != stored {got.dtype} — manifest and "
                    f"arrays.npz disagree (partial overwrite?)")
            loaded.append(got)
    return _unflatten(like_tree, iter(loaded)), manifest["extras"]


def wait_for_async(thread) -> None:
    """Join the writer thread of an ``async_write=True`` save (no-op for
    None)."""
    if thread is not None:
        thread.join()

"""`IndexStore` — persist built suffix-array indexes; restore, don't rebuild.

The port of `repro.api.store`, with the same on-disk form, so an index
saved by either package loads in the other. One directory per named
entry, written through the committed checkpoints of
`repro_torch.ckpt.checkpoint` (atomic rename + a `COMMITTED` marker)::

    <root>/<name>/step_00000000/
        arrays.npz       — text int64, sa int32, doc_starts int64
                           (+ lcp int64 when it was computed)
        manifest.json    — leaf shapes/dtypes + the index manifest extras
        COMMITTED

The extras carry what a restore is trusted on: ``format``
(`FORMAT_VERSION`), ``kind`` (dense or sparse), ``options_fingerprint``,
``plan``, ``corpus_sha256`` (`corpus_fingerprint` of the encoded text),
and ``n`` / ``n_docs`` / ``shift`` / ``sigma`` / ``sample_rate`` /
``has_lcp``. `load_index` raises `StaleIndexError` naming the check that
failed; `IndexStore.get_or_build` falls back to a build + save on it and
reports ``"hit" | "miss" | "stale"``.

**Plan names across the packages.** The two packages spell two plan
fields differently (`repro_torch.api.options.REFERENCE_NAMES`): the port's
``backend="torch"`` is the JAX package's ``"jax"``, its ``sort_impl``
``"torch"`` and ``"kernel"`` are ``"lax"`` and ``"pallas"``; every other
name is spelled alike. On disk both ``plan`` and ``options_fingerprint``
are written in the JAX package's names (`SAOptions.fingerprint` already
spells them so), and `load_index` translates ``plan`` back into the
port's names. So a default plan (``backend="auto"``, ``sort_impl=
"auto"``) is one entry for both packages, a port plan and its
counterpart there are one entry, and a different plan still raises
`StaleIndexError`.

`SegmentedIndexStore` lifts the same contract to a `SegmentedIndex`: one
versioned checkpoint per segment plus an atomically replaced corpus
manifest, synced **incrementally** (an ingest writes one segment).
Restored indexes land on the store's ``device``.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..ckpt.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..core.compat import resolve_device
from .index import SuffixArrayIndex
from .options import REFERENCE_NAMES, SAOptions
from .segments import Segment, SegmentedIndex

#: bump when the on-disk layout or manifest fields change incompatibly.
FORMAT_VERSION = 1

#: corpus-level manifest version for segmented entries (independent of the
#: per-segment checkpoint format above).
SEG_FORMAT_VERSION = 1

_KIND = "suffix-array-index"
_SPARSE_KIND = "sparse-suffix-array-index"
_SEG_KIND = "segmented-suffix-array-index"


class StaleIndexError(RuntimeError):
    """A persisted index exists but no longer matches what was asked for
    (format version, construction plan, or corpus content)."""


def corpus_fingerprint(text) -> str:
    """Content hash of an encoded text buffer (dtype-normalised sha256).

    This is the store's corpus identity: one linear pass on the host,
    far cheaper than the build it may save. `encode_docs` output,
    `SuffixArrayIndex.text` (a tensor on any device) and the JAX
    package's `corpus_fingerprint` agree for the same corpus.
    """
    if isinstance(text, torch.Tensor):
        text = text.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(text, np.int64))
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _disk_plan(opts: SAOptions) -> dict:
    """The plan fields persisted with an index, in the JAX package's
    names (callable schedules don't round-trip: None)."""
    return {
        "backend": REFERENCE_NAMES["backend"].get(opts.backend, opts.backend),
        "v0": opts.v0,
        "schedule": opts.schedule if isinstance(opts.schedule, str) else None,
        "base_threshold": opts.base_threshold,
        "sort_impl": REFERENCE_NAMES["sort_impl"].get(opts.sort_impl,
                                                      opts.sort_impl),
        "pack_keys": opts.pack_keys,
        "sample_rate": opts.sample_rate,
    }


def _plan_options(plan: dict) -> SAOptions | None:
    """`SAOptions` of a persisted plan, its names translated to the port's.

    A callable schedule doesn't round-trip: every other plan field is kept
    and the schedule falls back to the default (the SA is
    schedule-invariant; only the fingerprint's schedule part is lost)."""
    plan = dict(plan or {})
    if not plan:
        return None
    if plan.get("schedule") is None:
        plan.pop("schedule", None)
    for field, names in REFERENCE_NAMES.items():
        port = {ref: ours for ours, ref in names.items()}
        if field in plan:
            plan[field] = port.get(plan[field], plan[field])
    return SAOptions(**plan)


def _index_tree(index: SuffixArrayIndex) -> dict:
    tree = {"text": index.text.cpu().numpy(), "sa": index.sa.cpu().numpy(),
            "doc_starts": index.doc_starts}
    if index._lcp is not None:
        tree["lcp"] = index._lcp
    return tree


def save_index(path: str, index: SuffixArrayIndex, *, step: int = 0) -> str:
    """Persist `index` under `path` (one committed step_<step> entry).

    Returns `path`. The LCP array is included only if it was already
    computed — saving never forces the Kasai pass. `step` versions the
    checkpoint: `load_index` restores the latest committed step, and
    `SegmentedIndexStore` bumps it on every re-save so a rolled-back
    segment is detectable against the corpus manifest.
    """
    opts = index.options
    rate = int(getattr(index, "sample_rate", 1))
    tree = _index_tree(index)
    extras = {
        "format": FORMAT_VERSION,
        # a sparse index persists under its own kind: its `sa` leaf covers
        # only every rate-th position, so a dense reader must refuse it
        # (and vice versa) even before the fingerprint check
        "kind": _SPARSE_KIND if rate > 1 else _KIND,
        "n": index.n,
        "n_docs": index.n_docs,
        "shift": index.shift,
        "sigma": index.sigma,
        "sample_rate": rate,
        "has_lcp": index._lcp is not None,
        "options_fingerprint": opts.fingerprint(),
        # the plan fields themselves, so load_index can reconstruct the
        # SAOptions and a restored index re-saves with the SAME fingerprint
        "plan": _disk_plan(opts),
        "corpus_sha256": corpus_fingerprint(tree["text"]),
        "created_unix": time.time(),
    }
    save_checkpoint(path, int(step), tree, extras=extras)
    return path


def _read_manifest(path: str, step: int) -> dict:
    mpath = os.path.join(path, f"step_{step:08d}", "manifest.json")
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise StaleIndexError(f"unreadable index manifest at {mpath}: {e}")


def load_index(path: str, *, options: SAOptions | None = None,
               expect_corpus_sha: str | None = None,
               expect_step: int | None = None,
               device="cuda") -> SuffixArrayIndex:
    """Restore a `SuffixArrayIndex` persisted by `save_index` (of either
    package) onto `device`.

    Raises `FileNotFoundError` when no committed entry exists, and
    `StaleIndexError` when one exists but fails a staleness check:
    unknown format version, `options.fingerprint()` mismatch (pass
    ``options`` to enforce the plan), `expect_corpus_sha` mismatch
    (pass the current corpus hash to enforce content identity), or a
    latest committed step other than `expect_step` (how the segmented
    store detects a rolled-back or partially-synced segment). Leaf
    shapes/dtypes are validated by `repro_torch.ckpt.checkpoint
    .restore_checkpoint` against the manifest, so a truncated or
    hand-edited `arrays.npz` raises instead of restoring garbage.
    """
    device = resolve_device(device)
    step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no committed index entry under {path!r}")
    if expect_step is not None and step != expect_step:
        raise StaleIndexError(
            f"index at {path!r} is at step {step}, expected {expect_step} "
            f"— rolled back or partially synced")
    manifest = _read_manifest(path, step)
    extras = manifest.get("extras", {})
    if extras.get("kind") not in (_KIND, _SPARSE_KIND):
        raise StaleIndexError(
            f"{path!r} is not a suffix-array index artifact "
            f"(kind={extras.get('kind')!r})")
    rate = int(extras.get("sample_rate", 1))
    if (extras.get("kind") == _SPARSE_KIND) != (rate > 1):
        raise StaleIndexError(
            f"index at {path!r} records kind={extras.get('kind')!r} but "
            f"sample_rate={rate} — manifest tampered or half-written")
    if extras.get("format") != FORMAT_VERSION:
        raise StaleIndexError(
            f"index at {path!r} has format {extras.get('format')!r}, "
            f"this code reads {FORMAT_VERSION} — rebuild it")
    if options is not None:
        want, got = options.fingerprint(), extras.get("options_fingerprint")
        if want != got:
            raise StaleIndexError(
                f"index at {path!r} was built with plan {got!r}, "
                f"requested {want!r}")
    if expect_corpus_sha is not None and \
            extras.get("corpus_sha256") != expect_corpus_sha:
        raise StaleIndexError(
            f"index at {path!r} was built from a different corpus "
            f"(stored sha {extras.get('corpus_sha256')!r:.24} != expected "
            f"{expect_corpus_sha!r:.24})")

    # like_tree reconstructed from the manifest itself; flatten order of a
    # dict is sorted keys, matching the order shapes/dtypes were recorded.
    keys = ["doc_starts", "sa", "text"] + (["lcp"] if extras.get("has_lcp")
                                           else [])
    keys = sorted(keys)
    shapes, dtypes = manifest.get("shapes", []), manifest.get("dtypes", [])
    if len(shapes) != len(keys) or len(dtypes) != len(keys):
        raise StaleIndexError(
            f"index manifest at {path!r} records {len(shapes)} leaves, "
            f"expected {len(keys)} ({keys})")
    like = {k: np.zeros(tuple(s), np.dtype(d))
            for k, s, d in zip(keys, shapes, dtypes)}
    tree, extras = restore_checkpoint(path, step, like)
    # re-attach the construction plan so the restored index re-saves with
    # the same fingerprint: the caller's options when given (fingerprint
    # already verified above), else the persisted plan fields
    opts = options if options is not None else _plan_options(
        extras.get("plan"))
    if rate > 1:
        from ..sparse import SparseSuffixArrayIndex
        return SparseSuffixArrayIndex(
            tree["text"], tree["sa"], sample_rate=rate,
            doc_starts=tree["doc_starts"], shift=int(extras["shift"]),
            sigma=int(extras["sigma"]), options=opts, lcp=tree.get("lcp"),
            device=device)
    return SuffixArrayIndex(
        tree["text"], tree["sa"], doc_starts=tree["doc_starts"],
        shift=int(extras["shift"]), sigma=int(extras["sigma"]),
        options=opts, lcp=tree.get("lcp"), device=device)


class IndexStore:
    """Named persistent indexes under one root directory, with traffic
    stats (hits, misses, stale rebuilds).

    >>> store = IndexStore(root, device="cpu")            # doctest: +SKIP
    >>> index, status = store.get_or_build(
    ...     "corpus", lambda: SuffixArrayIndex.from_docs(
    ...         docs, opts, device="cpu"), options=opts)  # doctest: +SKIP

    `status` is ``"hit"`` (restored — the build was skipped entirely),
    ``"miss"`` (no entry yet) or ``"stale"`` (entry failed a staleness
    check); both non-hits build via `build_fn` and persist the result.
    Restored indexes land on `device`.
    """

    #: get_or_build status → stats counter key
    _STATUS_KEY = {"hit": "hits", "miss": "misses", "stale": "stale"}

    def __init__(self, root: str, *, device="cuda"):
        self.root = str(root)
        self.device = resolve_device(device)
        self._stats = {"hits": 0, "misses": 0, "stale": 0}
        self._stats_lock = threading.Lock()

    def _record(self, status: str) -> None:
        """Count one *completed* get_or_build outcome.

        Called only when the (index, status) pair is actually being
        returned, under a lock: a build_fn that raises must not leave a
        phantom miss/stale behind, and concurrent sessions must not lose
        increments — `stats()` is the serving-side "did the restart skip
        the build" metric, so it has to be exact."""
        with self._stats_lock:
            self._stats[self._STATUS_KEY[status]] += 1

    def path(self, name: str) -> str:
        if not name or os.sep in name or name.startswith("."):
            raise ValueError(f"invalid index entry name {name!r}")
        return os.path.join(self.root, name)

    def entries(self) -> list[str]:
        """Names with a committed entry, sorted."""
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if latest_step(os.path.join(self.root, d)) is not None)

    def save(self, name: str, index: SuffixArrayIndex) -> str:
        return save_index(self.path(name), index)

    def load(self, name: str, *, options: SAOptions | None = None,
             expect_corpus_sha: str | None = None) -> SuffixArrayIndex:
        return load_index(self.path(name), options=options,
                          expect_corpus_sha=expect_corpus_sha,
                          device=self.device)

    def manifest_age(self, name: str) -> float | None:
        """Seconds since the entry's manifest was written, or None."""
        step = latest_step(self.path(name))
        if step is None:
            return None
        mpath = os.path.join(self.path(name), f"step_{step:08d}",
                             "manifest.json")
        try:
            return max(time.time() - os.path.getmtime(mpath), 0.0)
        except OSError:
            return None

    def get_or_build(self, name: str,
                     build_fn: Callable[[], SuffixArrayIndex], *,
                     options: SAOptions | None = None,
                     corpus_sha: str | None = None,
                     ) -> tuple[SuffixArrayIndex, str]:
        """Restore `name` if fresh, else build, persist, and return.

        Returns ``(index, status)`` with status in {"hit", "miss",
        "stale"}. On a hit the builder never runs — the
        ``repro_torch.builds`` counter does not move.

        Stats are updated atomically with the returned index (under a
        lock, only once the non-hit path has actually built AND
        persisted): a `build_fn` that raises on the stale-then-rebuild
        path propagates the exception and leaves `stats()` untouched,
        instead of recording a rebuild that never happened.
        """
        try:
            index = self.load(name, options=options,
                              expect_corpus_sha=corpus_sha)
            status = "hit"
        except FileNotFoundError:
            index, status = None, "miss"
        except StaleIndexError:
            index, status = None, "stale"
        if index is None:
            index = build_fn()
            self.save(name, index)
        self._record(status)
        return index, status

    def stats(self) -> dict:
        """Traffic snapshot: entries on disk + hits/misses/stale so far."""
        with self._stats_lock:
            counts = dict(self._stats)
        return {"entries": len(self.entries()), **counts}

    def __repr__(self) -> str:
        return f"IndexStore(root={self.root!r}, stats={self.stats()})"


# ---------------------------------------------------------------------------
# segmented persistence
# ---------------------------------------------------------------------------
_SEG_ID_RE = re.compile(r"^seg-\d{6,}$")


class SegmentedIndexStore:
    """Persist a `SegmentedIndex`: one versioned checkpoint per
    segment plus a corpus-level manifest — ingest persists one small
    segment, never the corpus.

    Layout (one directory per named entry)::

        <root>/<name>/
            corpus.json              — corpus-level manifest (atomic write)
            segments/<seg_id>/       — one `save_index` checkpoint each
                step_<version>/{arrays.npz, manifest.json, COMMITTED}

    ``corpus.json`` pins the corpus: the segment list with each segment's
    global doc ids, checkpoint step, encoded length, and corpus sha. A
    segment whose latest committed step, content hash, or length disagrees
    with the manifest loads as `StaleIndexError` (rolled back, tampered,
    or half-synced), never as silently wrong query results.

    `save` is **incremental**: only segments marked dirty on the
    `SegmentedIndex` (new since the last sync) are written, and segments
    dropped by delete/compaction are garbage-collected; the returned
    traffic dict shows that a single-doc ingest persists one segment.
    Restored segments land on `device`.
    """

    _STATUS_KEY = IndexStore._STATUS_KEY

    def __init__(self, root: str, *, device="cuda"):
        self.root = str(root)
        self.device = resolve_device(device)
        self._stats = {"hits": 0, "misses": 0, "stale": 0,
                       "segments_written": 0, "segments_deleted": 0,
                       "segments_loaded": 0}
        self._stats_lock = threading.Lock()

    def path(self, name: str) -> str:
        if not name or os.sep in name or name.startswith("."):
            raise ValueError(f"invalid index entry name {name!r}")
        return os.path.join(self.root, name)

    def _manifest_path(self, name: str) -> str:
        return os.path.join(self.path(name), "corpus.json")

    def _segment_path(self, name: str, seg_id: str) -> str:
        if not _SEG_ID_RE.match(seg_id):
            raise StaleIndexError(f"invalid segment id {seg_id!r} in "
                                  f"entry {name!r}")
        return os.path.join(self.path(name), "segments", seg_id)

    def entries(self) -> list[str]:
        """Names with a corpus manifest, sorted."""
        if not os.path.isdir(self.root):
            return []
        return sorted(d for d in os.listdir(self.root)
                      if os.path.exists(self._manifest_path(d)))

    # ------------------------------------------------------------- persist
    def save(self, name: str, sidx: SegmentedIndex) -> dict:
        """Sync `sidx` to disk incrementally; returns the traffic dict
        ``{"segments_written": w, "segments_deleted": d}``.

        Dirty segments are checkpointed (at the next step when the
        directory already exists — a versioned re-save, not an
        overwrite), dropped segments' directories are removed, and the
        corpus manifest is atomically replaced LAST, so a crash mid-sync
        leaves the previous manifest pointing at fully-committed
        segments."""
        written = deleted = 0
        for seg in sidx.segments:
            spath = self._segment_path(name, seg.seg_id)
            if seg.seg_id in sidx.dirty or latest_step(spath) is None:
                prev = latest_step(spath)
                seg.version = 0 if prev is None else prev + 1
                save_index(spath, seg.index, step=seg.version)
                written += 1
        for seg_id in sorted(sidx.dropped):
            spath = self._segment_path(name, seg_id)
            if os.path.isdir(spath):
                shutil.rmtree(spath)
                deleted += 1
        manifest = {
            "format": SEG_FORMAT_VERSION,
            "kind": _SEG_KIND,
            "options_fingerprint": sidx.options.fingerprint(),
            "sigma": sidx._sigma,
            "next_doc_id": sidx._next_doc_id,
            "next_seg": sidx._next_seg,
            "segments": [{
                "seg_id": seg.seg_id,
                "doc_ids": np.asarray(seg.doc_ids, np.int64).tolist(),
                "step": seg.version,
                "n": seg.n,
                "corpus_sha256": corpus_fingerprint(seg.index.text),
            } for seg in sidx.segments],
            "created_unix": time.time(),
        }
        os.makedirs(self.path(name), exist_ok=True)
        tmp = self._manifest_path(name) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._manifest_path(name))
        sidx.dirty.clear()
        sidx.dropped.clear()
        with self._stats_lock:
            self._stats["segments_written"] += written
            self._stats["segments_deleted"] += deleted
        return {"segments_written": written, "segments_deleted": deleted}

    # ------------------------------------------------------------- restore
    def load(self, name: str, *,
             options: SAOptions | None = None) -> SegmentedIndex:
        """Restore a segmented entry; zero builder traffic.

        Raises `FileNotFoundError` with no manifest, `StaleIndexError`
        when the manifest is unreadable/wrong-kind/wrong-format, when
        ``options.fingerprint()`` disagrees, or when any referenced
        segment is missing, rolled back to a different step, or fails its
        own content checks."""
        mpath = self._manifest_path(name)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no segmented index entry under {self.path(name)!r}")
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise StaleIndexError(f"unreadable corpus manifest {mpath}: {e}")
        if manifest.get("kind") != _SEG_KIND:
            raise StaleIndexError(
                f"{mpath} is not a segmented index manifest "
                f"(kind={manifest.get('kind')!r})")
        if manifest.get("format") != SEG_FORMAT_VERSION:
            raise StaleIndexError(
                f"segmented entry {name!r} has format "
                f"{manifest.get('format')!r}, this code reads "
                f"{SEG_FORMAT_VERSION} — rebuild it")
        if options is not None:
            want, got = options.fingerprint(), \
                manifest.get("options_fingerprint")
            if want != got:
                raise StaleIndexError(
                    f"segmented entry {name!r} was built with plan {got!r}, "
                    f"requested {want!r}")
        segments = []
        for ent in manifest.get("segments", []):
            spath = self._segment_path(name, str(ent.get("seg_id", "")))
            try:
                index = load_index(
                    spath, options=options,
                    expect_corpus_sha=ent.get("corpus_sha256"),
                    expect_step=int(ent.get("step", 0)), device=self.device)
            except FileNotFoundError as e:
                raise StaleIndexError(
                    f"segmented entry {name!r} references missing segment "
                    f"{ent.get('seg_id')!r}: {e}")
            if index.n != int(ent.get("n", -1)):
                raise StaleIndexError(
                    f"segment {ent.get('seg_id')!r} of entry {name!r} holds "
                    f"{index.n} chars, manifest records {ent.get('n')}")
            segments.append(Segment(
                seg_id=str(ent["seg_id"]),
                doc_ids=np.asarray(ent.get("doc_ids", []), np.int64),
                index=index, version=int(ent.get("step", 0))))
        opts = options
        if opts is None:
            opts = (segments[0].index.options if segments
                    else SAOptions())
        sidx = SegmentedIndex(
            segments, options=opts,
            sigma=manifest.get("sigma"),
            next_doc_id=int(manifest.get("next_doc_id", 0)),
            next_seg=int(manifest.get("next_seg", len(segments))),
            device=self.device)
        sidx.dirty.clear()          # just loaded: everything is in sync
        with self._stats_lock:
            self._stats["segments_loaded"] += len(segments)
        return sidx

    def get_or_build(self, name: str,
                     build_fn: Callable[[], SegmentedIndex], *,
                     options: SAOptions | None = None,
                     ) -> tuple[SegmentedIndex, str]:
        """Restore `name` if fresh, else build + persist. Returns
        ``(segmented_index, status)``, status in {"hit", "miss",
        "stale"}; stats update atomically with the successful return,
        same contract as `IndexStore.get_or_build`."""
        try:
            sidx = self.load(name, options=options)
            status = "hit"
        except FileNotFoundError:
            sidx, status = None, "miss"
        except StaleIndexError:
            sidx, status = None, "stale"
        if sidx is None:
            sidx = build_fn()
            self.save(name, sidx)
        with self._stats_lock:
            self._stats[self._STATUS_KEY[status]] += 1
        return sidx, status

    def stats(self) -> dict:
        """Traffic snapshot: entries on disk + hit/miss/stale counts +
        per-segment write/delete/load traffic since construction."""
        with self._stats_lock:
            counts = dict(self._stats)
        return {"entries": len(self.entries()), **counts}

    def __repr__(self) -> str:
        return f"SegmentedIndexStore(root={self.root!r}, stats={self.stats()})"

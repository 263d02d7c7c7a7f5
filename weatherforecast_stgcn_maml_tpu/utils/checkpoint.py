"""Checkpointing: numpy `.npz` for array trees + JSON sidecars.

Carries the same logical schema as the reference's torch.save dicts
(train_hybrid_maml_v5.py:311-335: model + Koppen + optimizer + scheduler
state + epoch + loss + architecture config; adapt_hybrid_v5.py:240-257 adds
region metadata + normalization stats) — and, unlike the reference, supports
true mid-run resume (optimizer state and epoch are reloaded, SURVEY.md
section 5 checkpoint/resume gap).

Layout of a checkpoint directory:
  <dir>/arrays.npz  every array leaf, stored as a0, a1, ...
  <dir>/tree.json   for each leaf its path in the saved tree and its npz key
  <dir>/meta.json   metadata: config dict, norm stats, epoch, losses, tags

A leaf's path is a list of [kind, key] steps: "d" a dict key, "a" a
NamedTuple field (optax states, MamlState), "s" a list/tuple index. A raw
restore rebuilds dicts for "d"/"a" and lists for "s".
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import jax.tree_util as jtu
import numpy as np


def _to_jsonable(x):
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def _typed_path(keypath) -> list:
    out = []
    for e in keypath:
        if isinstance(e, jtu.DictKey):
            out.append(["d", str(e.key)])
        elif isinstance(e, jtu.GetAttrKey):
            out.append(["a", e.name])
        elif isinstance(e, jtu.SequenceKey):
            out.append(["s", e.idx])
        else:
            raise TypeError(f"checkpoint: unsupported pytree node {e!r}")
    return out


def _canon(typed_path) -> str:
    """Path key independent of container kind: a NamedTuple field and a
    dict key of the same name compare equal (a raw restore turns the one
    into the other)."""
    return "/".join(str(k) for _, k in typed_path)


def save_checkpoint(path: str, arrays, meta: dict | None = None) -> str:
    """Save `arrays` (any pytree of jax/numpy arrays) + JSON `meta`.

    Overwrites an existing checkpoint at `path` atomically-ish (write to a
    sibling tmp dir, then swap).
    """
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    flat, _ = jtu.tree_flatten_with_path(arrays)
    leaves = [
        {"path": _typed_path(kp), "key": f"a{i}"} for i, (kp, _) in enumerate(flat)
    ]
    np.savez(
        os.path.join(tmp, "arrays.npz"),
        **{f"a{i}": np.asarray(v) for i, (_, v) in enumerate(flat)},
    )
    with open(os.path.join(tmp, "tree.json"), "w") as f:
        json.dump({"leaves": leaves}, f)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(_to_jsonable(meta or {}), f, indent=2)

    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


class AsyncCheckpointer:
    """Overlapped checkpoint writes.

    A save costs a device->host fetch of the params/opt-state tree plus the
    file write. The training loop also DONATES its state into the next step,
    so a background thread must never touch the live buffers. `save()`
    therefore:

      1. snapshots the tree on device (`jnp.copy` — a device-to-device copy
         into fresh buffers, safe against donation), then
      2. hands the snapshot to a single background thread that performs the
         fetch + npz/JSON write while the main thread dispatches the next
         steps.

    One save is in flight at a time (a new `save()` joins the previous one,
    preserving write order per path); `wait()` must be called before
    reading the checkpoint back or returning from the engine, and re-raises
    any background failure loudly.
    """

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, path: str, arrays, meta: dict | None = None) -> None:
        import threading

        import jax.numpy as jnp

        self.wait()
        # Snapshot EVERY mutable input before handing off to the thread:
        # device arrays via jnp.copy (async, rides under compute), host
        # numpy leaves via np.copy, and the meta dict itself — the caller
        # may mutate any of them (difficulty EMAs, sampler state) while the
        # background write is in flight.
        import copy as _copy

        import numpy as _np

        snapshot = jax.tree.map(
            lambda x: jnp.copy(x)
            if isinstance(x, jax.Array)
            else (_np.copy(x) if isinstance(x, _np.ndarray) else x),
            arrays,
        )
        meta = _copy.deepcopy(meta)

        def _write():
            try:
                save_checkpoint(path, snapshot, meta)
            except BaseException as e:  # surfaced by the next wait()
                self._error = e

        self._thread = threading.Thread(
            target=_write, name="wfstgcn-async-ckpt", daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err


def _assemble(items):
    """Rebuild a raw tree from (typed_path, value) pairs sharing a level."""
    if len(items) == 1 and not items[0][0]:
        return items[0][1]
    groups: dict = {}
    for p, v in items:
        groups.setdefault(p[0][1], []).append((p[1:], v))
    sub = {k: _assemble(g) for k, g in groups.items()}
    if items[0][0][0][0] == "s":
        return [sub[i] for i in sorted(sub)]
    return sub


def load_checkpoint(path: str, like=None):
    """Load (arrays, meta) from `path`.

    `like` optionally provides a template pytree so arrays restore with the
    exact structure (recommended for opt_state trees, whose NamedTuples a
    raw restore turns into dicts). A `like` covering only a subtree of what
    was saved (e.g. params without opt_state) restores just that subtree.

    The SAVED structure is authoritative: if a `like` subtree's leaf paths
    are not all present in the checkpoint (e.g. a template built with fused
    LSTM biases reading a checkpoint of torch-imported split `b_ih`/`b_hh`
    leaves), that subtree is restored raw with the checkpoint's own
    structure instead — never with the template's (random-init) values for
    the missing leaves, which once corrupted adaptation from imported
    weights.
    """
    path = os.path.abspath(path)
    with open(os.path.join(path, "tree.json")) as f:
        leaves = json.load(f)["leaves"]
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        saved = [(e["path"], npz[e["key"]]) for e in leaves]
    by_canon = {_canon(p): v for p, v in saved}

    def templated(subtree):
        """`subtree` filled with the saved leaves, or None if not covered."""
        flat, treedef = jtu.tree_flatten_with_path(subtree)
        keys = [_canon(_typed_path(kp)) for kp, _ in flat]
        if not all(k in by_canon for k in keys):
            return None
        return treedef.unflatten([by_canon[k] for k in keys])

    raw = _assemble(saved) if saved else {}
    if like is None:
        arrays = raw
    elif isinstance(like, dict):
        arrays = {}
        for k, v in like.items():
            got = templated({k: v})
            arrays[k] = got[k] if got is not None else raw[k]
    else:
        got = templated(like)
        arrays = got if got is not None else raw
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return arrays, meta


def checkpoint_exists(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "meta.json"))


def load_meta(path: str) -> dict:
    """Read only the JSON metadata of a checkpoint (cheap peek)."""
    with open(os.path.join(os.path.abspath(path), "meta.json")) as f:
        return json.load(f)


def check_family(meta: dict, expected_family: str, path: str) -> None:
    """Fail with a clear message when a checkpoint was trained with a
    different model family than the current config expects (the structure
    mismatch this preempts would surface as a cryptic shape error)."""
    saved = (meta.get("config") or {}).get("model", {}).get("family")
    if saved is not None and saved != expected_family:
        raise ValueError(
            f"checkpoint {path} holds a {saved!r}-family model but the "
            f"current config expects {expected_family!r}; pass "
            f"-o model.family={saved} (and matching architecture overrides)"
        )

"""Fault-tolerant checkpointing: npz shards + a JSON manifest.

The port of :mod:`repro.checkpoint.store`, in the same on-disk format,
so a checkpoint written by either package loads in the other:
``step_<8 digits>/`` holding one ``arrays.npz`` (leaves ``a0..an`` in
tree order) and a ``manifest.json`` with ``paths``, ``dtypes``,
``shapes``, ``sha256`` and ``extra``.  The tree order and the paths are
those of ``jax.tree.flatten``: dict keys sorted, lists and tuples in
order, ``None`` holding no leaf, path parts joined by ``/``
(``params/0/b``, ``prof/L_u``).  bf16 is stored as its ``uint16`` bits
under the dtype tag ``"bfloat16"``.

* **Atomicity** — writes go to ``step_<k>.tmp/`` and are ``os.rename``d
  into place only after every array and the manifest have been fsynced;
  a crash mid-write can never produce a half-checkpoint that
  ``latest_step`` would pick up.
* **Placement on load** — arrays are stored unsharded; a leaf whose
  ``like`` is a tensor comes back as a tensor on that tensor's device
  (or on ``device`` when one is given), any other leaf as the exact host
  numpy array that was saved (the loop's float64 profile rows).
* **Keep-N retention** with the manifest updated last, so garbage
  collection of an old step can never race a reader of the newest one.
* **Self-describing manifest** — tree structure, dtypes, shapes, step,
  and a payload checksum; loads verify structure before touching the
  model.
* **Stray-entry tolerance** — only names matching ``step_\\d{8}`` are
  checkpoints; lock files, notes, or foreign directories in the store
  are ignored by :func:`latest_step` and the keep-N GC.
* **Corrupt-newest fallback** — :meth:`CheckpointManager.restore_latest`
  skips an unreadable newest step (torn payload, missing manifest) with
  a warning and restores the previous one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union
from zipfile import BadZipFile as zipfile_BadZipFile

import numpy as np
import torch

Params = Any
Device = Optional[Union[str, torch.device]]

# Checkpoint dirs are exactly ``step_<8+ digits>``; anything else in the
# store (lock files, ``step_notes.txt``, foreign dirs) is not ours.
_STEP_RE = re.compile(r"step_(\d{8,})")


def _step_of(name: str) -> Optional[int]:
    m = _STEP_RE.fullmatch(name)
    return int(m.group(1)) if m else None


def _list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = [_step_of(d) for d in os.listdir(directory)]
    return sorted(s for s in steps if s is not None)


def _fsync_dir(path: str) -> None:
    """fsync a directory so its entries (renames, new files) are durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _walk(tree: Params, path: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in ``jax.tree.flatten`` order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree: Params, leaves: Iterator[Any]) -> Params:
    """``tree``'s structure filled from ``leaves`` (in :func:`_walk`
    order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """The array to store and its dtype tag (bf16 as ``uint16`` bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Params,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write ``tree`` (params/metadata) at ``step``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    paths, arrays, dtypes, shapes = [], {}, {}, {}
    for i, (path, leaf) in enumerate(_walk(tree)):
        arr, tag = _to_host(leaf)
        paths.append(path)
        arrays[f"a{i}"], dtypes[f"a{i}"] = arr, tag
        shapes[f"a{i}"] = list(arr.shape)
    payload = os.path.join(tmp, "arrays.npz")
    with open(payload, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(payload, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()

    manifest = {
        "step": step,
        "paths": paths,
        "dtypes": dtypes,
        "shapes": shapes,
        "sha256": digest,
        "extra": extra or {},
    }
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # Durability order: payload + manifest fsynced above, then the tmp
    # dir (so both entries survive), then the rename, then the parent
    # dir (so the rename itself survives).
    _fsync_dir(tmp)
    os.rename(tmp, final)
    _fsync_dir(directory)
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return steps[-1] if steps else None


def read_extra(directory: str, step: int) -> Dict[str, Any]:
    """Read only the manifest's ``extra`` dict (cheap, no arrays).

    Two-phase restore: the extra carries JSON metadata (fleet
    membership, schedule, RNG seed, ...) that callers may need to
    reconstruct the ``like`` tree before loading the arrays."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get("extra", {})


def _from_host(arr: np.ndarray, tag: str, like: Any,
               device: Device) -> Any:
    """A stored array as the leaf ``like`` stands for: a tensor on
    ``device`` (or on ``like``'s device when ``like`` is a tensor), else
    the host array itself.  bf16 has no numpy dtype, so it always comes
    back as a tensor."""
    if tag == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif device is not None or isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr)
    else:
        return arr
    if device is None:
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(device)


def load_checkpoint(directory: str, step: int, like: Params,
                    device: Device = None, verify: bool = True) -> Params:
    """Restore into the structure of ``like``.  With ``device`` every
    leaf comes back as a tensor there; without, each tensor leaf of
    ``like`` names its own device and the rest stay host numpy."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    walked = list(_walk(like))
    want_paths = [p for p, _ in walked]
    if manifest["paths"] != want_paths:
        missing = set(want_paths) - set(manifest["paths"])
        extra = set(manifest["paths"]) - set(want_paths)
        raise ValueError(f"checkpoint/model structure mismatch: "
                         f"missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    payload = os.path.join(path, "arrays.npz")
    if verify:
        with open(payload, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != manifest["sha256"]:
            raise IOError(f"checkpoint {path} payload corrupt")
    with np.load(payload) as data:
        out = [_from_host(data[f"a{i}"], manifest["dtypes"][f"a{i}"], leaf,
                          device)
               for i, (_, leaf) in enumerate(walked)]
    return _rebuild(like, iter(out))


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def save(self, step: int, tree: Params,
             extra: Optional[Dict[str, Any]] = None) -> str:
        path = save_checkpoint(self.directory, step, tree, extra)
        self._gc()
        return path

    def restore_latest(self, like: Params, device: Device = None):
        return self.restore_latest_with(lambda step, extra: like,
                                        device)[:2]

    def restore_latest_with(self, like_fn: Callable[[int, Dict[str, Any]],
                                                    Params],
                            device: Device = None,
                            ) -> Tuple[Optional[int], Optional[Params],
                                       Optional[Dict[str, Any]]]:
        """Restore the newest readable step, building the target tree
        from its manifest extra via ``like_fn(step, extra)``.

        A corrupt or torn newest step is skipped with a warning and the
        previous step is tried; the last error is raised only if *every*
        step is unreadable."""
        steps = _list_steps(self.directory)
        last_err: Optional[BaseException] = None
        for step in reversed(steps):
            try:
                extra = read_extra(self.directory, step)
                like = like_fn(step, extra)
                tree = load_checkpoint(self.directory, step, like, device)
                return step, tree, extra
            except (OSError, ValueError, KeyError, zipfile_BadZipFile) as e:
                warnings.warn(
                    f"checkpoint step {step} in {self.directory} is "
                    f"unreadable ({type(e).__name__}: {e}); falling back "
                    f"to the previous step", RuntimeWarning, stacklevel=2)
                last_err = e
        if last_err is not None:
            raise last_err
        return None, None, None

    def _gc(self) -> None:
        for s in _list_steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

"""Checkpoints of a training state: atomic step directories, async save.

Port of ``repro.distributed.checkpoint``.  Layout on disk (one directory
per step):

    ckpt_dir/step_000000042/
      manifest.json        leaf paths, shapes, dtypes, step, digest
      arrays/<idx>.bin     one raw-bytes file per leaf (dtype in manifest)
      COMMITTED            written last

* **atomic commit**: written to ``<dir>.tmp``, then renamed; ``COMMITTED``
  guards against torn checkpoints, and :func:`latest_step` sees only
  committed ones;
* **async save**: :class:`AsyncCheckpointer` copies the tensors to host
  memory before it returns, then writes on a background thread;
* an integrity digest over all leaf bytes, checked on restore.

A tree is nested dicts (keys sorted when flattened) and lists of tensors,
numpy arrays or :class:`~repro_torch.distributed.placement.ShardedTensor`
leaves; :meth:`repro_torch.training.TrainState.as_tree` gives a training
state's (:class:`~repro_torch.training.ShardedTrainState`'s over a mesh).
``save`` writes every leaf whole, gathering a sharded leaf's shards, so a
checkpoint does not depend on the mesh that wrote it.  ``restore`` puts
each leaf where ``shardings`` says (a matching tree of
:class:`~repro_torch.distributed.sharding.Sharding`: the leaf split onto
that mesh, which may differ from the writer's — the elastic re-mesh),
else where the example leaf lies: a sharded example's placement, or a
tensor's device and dtype.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.placement import ShardedTensor, place


def _flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _unflatten(tree, leaves: list):
    """``tree``'s structure with its leaves replaced in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = build(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def _host(leaf) -> tuple[np.ndarray, str]:
    """(host array, dtype name) of a leaf; bf16 travels as its raw 16
    bits."""
    if isinstance(leaf, ShardedTensor):
        leaf = _whole(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _whole(st: ShardedTensor) -> torch.Tensor:
    """A sharded leaf gathered whole on the host."""
    with torch.no_grad():
        return st.gather("cpu").detach()


def _snapshot(leaf):
    """A host copy that later writes to the device cannot change."""
    if isinstance(leaf, ShardedTensor):
        return _whole(leaf).clone()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic checkpoint write. Returns the final path."""
    leaves = [(path, *_host(leaf)) for path, leaf in _flatten(tree)]
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)

    digest = hashlib.sha256()
    meta = []
    for i, (path, arr, dtype) in enumerate(leaves):
        raw = arr.tobytes()
        with open(os.path.join(tmp, "arrays", f"{i}.bin"), "wb") as f:
            f.write(raw)
        digest.update(raw)
        meta.append({"path": path, "shape": list(arr.shape),
                     "dtype": dtype})
    manifest = {"step": step, "n_leaves": len(leaves), "leaves": meta,
                "digest": digest.hexdigest()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot-then-write-on-thread. One in-flight save at a time."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        # snapshot to host memory before returning control
        host_tree = _unflatten(tree, [_snapshot(leaf)
                                      for _, leaf in _flatten(tree)])

        def work():
            try:
                save(self.ckpt_dir, step, host_tree)
            except Exception as e:            # pragma: no cover
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _leaf_from_bytes(raw: bytes, meta: dict) -> torch.Tensor:
    if meta["dtype"] == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(meta["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
    return torch.from_numpy(arr.reshape(meta["shape"]).copy())


def restore(ckpt_dir: str, step: int, example_tree: Any,
            shardings: Any = None, *, verify: bool = True) -> Any:
    """The checkpoint of ``step`` in the structure of ``example_tree``:
    each leaf placed by its :class:`~repro_torch.distributed.sharding.
    Sharding` in ``shardings`` (a tree of the same structure; a sharded
    leaf, in the example's dtype), else as the example leaf is (a sharded
    example's placement, or a tensor on its device and of its dtype)."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    if not os.path.exists(os.path.join(path, "COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    refs = _flatten(example_tree)
    places = [sh for _, sh in _flatten(shardings)] if shardings is not None \
        else [None] * len(refs)
    if len(places) != len(refs):
        raise ValueError(f"shardings hold {len(places)} leaves, the example "
                         f"tree {len(refs)}")
    if manifest["n_leaves"] != len(refs):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(refs)}")
    digest = hashlib.sha256()
    out = []
    for i, (leaf_path, ref) in enumerate(refs):
        meta = manifest["leaves"][i]
        if meta["path"] != leaf_path:
            raise ValueError(f"leaf {i}: checkpoint holds {meta['path']!r}, "
                             f"expected {leaf_path!r}")
        with open(os.path.join(path, "arrays", f"{i}.bin"), "rb") as f:
            raw = f.read()
        if verify:
            digest.update(raw)
        t = _leaf_from_bytes(raw, meta)
        shape = tuple(ref.shape)
        if tuple(t.shape) != shape:
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(t.shape)} "
                             f"!= {shape}")
        if places[i] is not None and t.ndim:
            t = place(t, places[i], dtype=ref.dtype)
        elif isinstance(ref, ShardedTensor):
            t = place(t, ref.sharding, dtype=ref.dtype)
        elif isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        out.append(t)
    if verify and digest.hexdigest() != manifest["digest"]:
        raise ValueError("checkpoint digest mismatch (corrupt files)")
    return _unflatten(example_tree, out)

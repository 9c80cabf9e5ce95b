"""Checkpointing to the ObjectStore — training's durable state, through the
same versioned-asset machinery the paper uses for index switch-over (§3) —
the port of ``repro/checkpoint/manager.py``.

A checkpoint is one asset version (``ckpt/<name>`` at version
``step-%09d``): each leaf of the state tree is one ``.npy`` object plus a
JSON manifest of keys, files, shapes and dtypes. Publishing is atomic
(AssetCatalog's compare-and-set manifest), so a crash mid-save never
corrupts the restore point.

The files are the reference's bytes for the same state: leaves in its
order (dict keys sorted, list entries in order), keys joined with ``/``,
``np.save``'s format. A bf16 leaf is written as the reference writes one
(``ml_dtypes.bfloat16`` through ``np.save``): descr ``'<V2'`` and
``"dtype": "bfloat16"`` in the manifest. The reference reads such a file
back as a ``|V2`` array; here the manifest's dtype turns those two bytes
back into ``torch.bfloat16`` (ROADMAP Queue 3).

``CheckpointManager`` adds: save-every-N cadence, async save (the state is
copied to host memory first, then a thread writes while training goes on),
keep-last-K GC, and restore-latest. A restore lands on the device of each
``shardings`` placement when given, else on the device of the ``like``
tree's leaf (the CPU for a leaf on the ``meta`` device or not a tensor).
"""

from __future__ import annotations

import dataclasses
import io
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import jsonutil as orjson   # orjson when installed
from repro_torch.core.directory import RamDirectory
from repro_torch.core.object_store import ObjectStore
from repro_torch.core.refresh import AssetCatalog

_NP_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
             torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
             torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
             torch.bool: "bool"}


def tree_leaves_with_path(tree: Any, path: tuple = ()) -> list:
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    lists and tuples in order; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree) for pl in tree_leaves_with_path(t, path + (i,))]
    return [(path, tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` into ``like``'s structure, in :func:`tree_leaves_with_path`'s order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def _leaf_key(path) -> str:
    return "/".join(str(p) for p in path) or "_root"


def _to_numpy(leaf) -> tuple[np.ndarray, str, bool]:
    """(array, manifest dtype, is bf16) of one leaf, on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16", True
        return t.numpy(), _NP_NAMES.get(t.dtype, str(t.numpy().dtype)), False
    arr = np.asarray(leaf)
    return arr, str(arr.dtype), False


def _npy_bytes(arr: np.ndarray, bf16: bool) -> bytes:
    buf = io.BytesIO()
    if bf16:    # np.save of an ml_dtypes bfloat16 array: descr '<V2', the raw 2-byte words
        arr = np.array(arr, order="C")      # (ascontiguousarray would make a 0-d array 1-d)
        np.lib.format.write_array_header_1_0(
            buf, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        buf.write(arr.tobytes())
    else:
        np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def save_pytree(tree: Any) -> RamDirectory:
    """Serialize a tree of tensors (or arrays) into Directory files + manifest."""
    d = RamDirectory()
    manifest = []
    for i, (path, leaf) in enumerate(tree_leaves_with_path(tree)):
        arr, dtype, bf16 = _to_numpy(leaf)
        fname = f"leaf{i:05d}.npy"
        d.write(fname, _npy_bytes(arr, bf16))
        manifest.append({"key": _leaf_key(path), "file": fname,
                         "shape": list(arr.shape), "dtype": dtype})
    d.write("manifest.json", orjson.dumps(manifest))
    return d


def _device_of(leaf, sharding) -> torch.device:
    if sharding is not None:
        return torch.device(getattr(sharding, "device", sharding))
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return torch.device("cpu")


def load_pytree(directory, like: Any, *, shardings: Any = None) -> Any:
    """Read leaves back as tensors and unflatten into ``like``'s structure,
    each on its ``shardings`` placement's device if given, else on the
    device of ``like``'s leaf."""
    manifest = orjson.loads(directory.open_input("manifest.json").read_all())
    leaves_like = [leaf for _, leaf in tree_leaves_with_path(like)]
    if len(manifest) != len(leaves_like):
        raise ValueError(f"checkpoint has {len(manifest)} leaves, "
                         f"expected {len(leaves_like)}")
    for ent, leaf in zip(manifest, leaves_like):
        if tuple(ent["shape"]) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {ent['key']!r} has shape "
                f"{tuple(ent['shape'])}, expected {tuple(leaf.shape)} — "
                "stale checkpoint for a different config?")
    sh_leaves = ([s for _, s in tree_leaves_with_path(shardings)] if shardings is not None
                 else [None] * len(manifest))
    out = []
    for ent, leaf, sh in zip(manifest, leaves_like, sh_leaves):
        data = directory.open_input(ent["file"]).read_all()
        arr = np.load(io.BytesIO(data), allow_pickle=False)
        arr = np.array(arr, order="C")
        if ent["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(_device_of(leaf, sh)))
    return tree_unflatten(like, out)


@dataclasses.dataclass
class CheckpointConfig:
    every_steps: int = 50
    keep: int = 3
    async_save: bool = True


class CheckpointManager:
    def __init__(self, store: ObjectStore, name: str = "train",
                 config: CheckpointConfig | None = None) -> None:
        self.catalog = AssetCatalog(store, root="ckpt")
        self.name = name
        self.config = config or CheckpointConfig()
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None
        self.saves = 0
        self.save_seconds = 0.0

    # -- write ------------------------------------------------------------------

    def _version(self, step: int) -> str:
        return f"step-{step:09d}"

    def maybe_save(self, step: int, state: Any) -> bool:
        if step % self.config.every_steps != 0:
            return False
        self.save(step, state)
        return True

    def save(self, step: int, state: Any) -> None:
        # copy to host memory BEFORE the writer thread starts: the next
        # step may replace or reuse the state's device buffers
        host_state = tree_unflatten(state, [
            leaf.detach().to("cpu", copy=True) if isinstance(leaf, torch.Tensor)
            else np.array(leaf) for _, leaf in tree_leaves_with_path(state)])
        self.wait()                       # one in-flight save at a time

        def _write():
            t0 = time.perf_counter()
            d = save_pytree(host_state)
            self.catalog.publish(self.name, self._version(step), d)
            self.catalog.gc(self.name, keep=self.config.keep)
            self.save_seconds += time.perf_counter() - t0
            self.saves += 1

        def _guarded():
            try:
                _write()
            except BaseException as e:    # surfaced by wait()
                self._error = e

        if self.config.async_save:
            self._pending = threading.Thread(target=_guarded, daemon=True)
            self._pending.start()
        else:
            _write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- read -------------------------------------------------------------------

    def latest_step(self) -> int | None:
        try:
            v = self.catalog.current_version(self.name)
        except Exception:
            return None
        return int(v.split("-")[1])

    def restore(self, like: Any, *, step: int | None = None,
                shardings: Any = None) -> tuple[Any, int]:
        """Returns (state, step). Raises if no checkpoint exists."""
        self.wait()
        version = None if step is None else self._version(step)
        v, directory = self.catalog.open(self.name, version)
        state = load_pytree(directory, like, shardings=shardings)
        return state, int(v.split("-")[1])

    def restore_or_init(self, init_fn: Callable[[], Any], *,
                        shardings: Any = None) -> tuple[Any, int]:
        """The latest checkpoint, restored into ``init_fn()``'s structure
        (which checks its shapes), or ``init_fn()`` itself at step 0."""
        state = init_fn()
        try:
            return self.restore(state, shardings=shardings)
        except Exception:
            if shardings is not None:
                from repro_torch.ft.faults import reshard_state
                state = reshard_state(state, shardings)
            return state, 0

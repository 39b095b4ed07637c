"""Fault-tolerant checkpointing: sharded npz save/restore with async writes
(the port of the reference's ``checkpoint/checkpointer.py``), in the
reference's on-disk format, so either package restores what the other
wrote.

Layout per step:
    <dir>/step_000123/
        manifest.json         # tree structure, shapes, dtypes, step, extras
        shard_00000.npz       # flat leaves (single-host: one shard)
        _COMMITTED            # written LAST: torn checkpoints are ignored

Leaves are stored in the reference's flatten order (dict keys sorted,
NamedTuple fields in order); a bfloat16 leaf is stored as a ``uint8`` byte
view, its manifest dtype ``"bfloat16"``, and viewed back with torch.
``CheckpointManager.restore_latest`` returns the newest *committed* step;
async mode serializes and writes on a background thread, so the train loop
blocks only on the previous save (one outstanding write).

The commit primitive under the checkpoints, ``atomic_write_bytes`` /
``atomic_write_json``, is byte for byte the reference's; the fleet
journal's snapshots and WAL compaction commit through it too.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import shutil
import struct
import threading
import zipfile
import zlib
from typing import Any, Iterator, Optional

import numpy as np
import torch

from ..optim.tree import tree_leaves, tree_map

__all__ = ["CheckpointManager", "Checkpointer", "atomic_write_bytes", "atomic_write_json"]


def atomic_write_bytes(path, data: bytes, fsync: bool = True) -> None:
    """Crash-safe file write: write to a same-directory temp file, fsync it,
    then atomically rename over the destination — a reader never observes a
    torn file, only the old bytes or the new bytes."""
    path = pathlib.Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        fh.write(data)
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)


def atomic_write_json(path, obj, fsync: bool = True) -> None:
    """``atomic_write_bytes`` for a JSON-serializable object."""
    atomic_write_bytes(path, json.dumps(obj).encode(), fsync=fsync)


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host (a copy: the caller may keep
    updating the tensor in place), bfloat16 as its ``uint8`` byte view."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach().to("cpu", copy=True)
    return (t.view(torch.uint8) if t.dtype == torch.bfloat16 else t).numpy()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _shape(leaf) -> list:
    return list(leaf.shape) if isinstance(leaf, torch.Tensor) else list(np.shape(leaf))


def _describe(tree) -> str:
    """The tree's structure, leaves as ``*``, in the flatten order."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_describe(v) for v in tree)
        if hasattr(tree, "_fields"):
            return f"CustomNode(namedtuple[{type(tree).__name__}], [{inner}])"
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def _npz_leaves(path: pathlib.Path, n: int) -> Iterator[np.ndarray]:
    """The arrays ``leaf_0`` .. ``leaf_{n-1}`` of an ``np.savez`` archive, one
    at a time.  Each member, stored uncompressed as ``.npy`` version 1 or 2
    (as both packages' ``np.savez`` writes it), is read in one call at its
    offset, and its CRC-32 checked against the archive's; ``np.load`` reads
    it through the zip stream in 256 KiB pieces, each copied twice, which is
    slower on a checkpoint of many GB.  Any other member is refused."""
    with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
        for i in range(n):
            info = zf.getinfo(f"leaf_{i}.npy")
            fh.seek(info.header_offset)
            local = fh.read(30)
            start = info.header_offset + 30 + sum(struct.unpack("<HH", local[26:30]))
            fh.seek(start)
            version = (np.lib.format.read_magic(fh)
                       if info.compress_type == zipfile.ZIP_STORED else None)
            if version not in ((1, 0), (2, 0)):
                raise ValueError(f"{path}: leaf_{i} is not an uncompressed .npy of version 1 "
                                 f"or 2 (compression {info.compress_type}, version {version})")
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(fh)
            header_len = fh.tell() - start
            data = np.fromfile(fh, dtype=dtype, count=math.prod(shape))
            fh.seek(start)
            crc = zlib.crc32(data, zlib.crc32(fh.read(header_len)))
            if crc != info.CRC or data.size != math.prod(shape):
                raise ValueError(f"{path}: leaf_{i} is corrupt (CRC-32 {crc:#010x}, "
                                 f"expected {info.CRC:#010x})")
            yield data.reshape(shape[::-1]).T if fortran else data.reshape(shape)


class _HostLeaf:
    """A leaf copied to the host: its bytes, logical dtype and shape."""

    def __init__(self, leaf):
        self.array, self.dtype, self.shape = _host_array(leaf), _dtype_name(leaf), _shape(leaf)


class Checkpointer:
    """Low-level save/restore of one tree of tensors (or numpy arrays)."""

    def save(self, path: pathlib.Path, tree: Any, step: int,
             extras: Optional[dict] = None) -> None:
        path = pathlib.Path(path)
        tmp = path.with_name(path.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        leaves = [leaf if isinstance(leaf, _HostLeaf) else _HostLeaf(leaf)
                  for leaf in tree_leaves(tree)]
        np.savez(tmp / "shard_00000.npz",
                 **{f"leaf_{i}": leaf.array for i, leaf in enumerate(leaves)})
        manifest = {
            "step": int(step),
            "treedef": f"PyTreeDef({_describe(tree)})",
            "n_leaves": len(leaves),
            "shapes": [leaf.shape for leaf in leaves],
            "dtypes": [leaf.dtype for leaf in leaves],
            "extras": extras or {},
        }
        atomic_write_json(tmp / "manifest.json", manifest)
        atomic_write_bytes(tmp / "_COMMITTED", b"ok")
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)

    def restore(self, path: pathlib.Path, like: Any) -> tuple:
        """Restore into the structure of ``like``: each leaf takes the
        dtype and device of ``like``'s.  Returns (tree, manifest)."""
        path = pathlib.Path(path)
        if not (path / "_COMMITTED").exists():
            raise FileNotFoundError(f"checkpoint at {path} is not committed")
        manifest = json.loads((path / "manifest.json").read_text())
        like_leaves = tree_leaves(like)
        if len(like_leaves) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, expected {len(like_leaves)}")
        restored = []
        # one leaf on the host at a time
        for i, (got, want) in enumerate(zip(_npz_leaves(path / "shard_00000.npz",
                                                        manifest["n_leaves"]), like_leaves)):
            arr = torch.from_numpy(got)
            shape = tuple(manifest["shapes"][i])
            if arr.dtype == torch.uint8 and manifest["dtypes"][i] != "uint8":
                # byte view of a bfloat16 array: view it back
                arr = arr.view(getattr(torch, manifest["dtypes"][i])).reshape(shape)
            if tuple(arr.shape) != tuple(_shape(want)):
                raise ValueError(f"shape mismatch {tuple(arr.shape)} vs {_shape(want)}")
            if isinstance(want, torch.Tensor):
                restored.append(arr.to(device=want.device, dtype=want.dtype))
            else:
                restored.append(arr.numpy().astype(np.asarray(want).dtype))
        it = iter(restored)
        return tree_map(lambda _: next(it), like), manifest


class CheckpointManager:
    """Step-indexed checkpoint directory with retention + async save."""

    def __init__(self, directory, max_to_keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._ckpt = Checkpointer()
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}"

    def steps(self) -> list:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "_COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def wait(self) -> None:
        """Block until the outstanding save has finished; raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extras: Optional[dict] = None) -> None:
        self.wait()  # at most one outstanding async write
        # copy to the host on the calling thread, before the caller's next
        # in-place update
        host_tree = tree_map(_HostLeaf, tree)

        def do():
            try:
                self._ckpt.save(self._step_dir(step), host_tree, step, extras)
                self._gc()
            except Exception as e:  # raised by the next wait()
                self._error = e

        if self.async_save:
            self._pending = threading.Thread(target=do, daemon=True)
            self._pending.start()
        else:
            do()
            self.wait()

    def restore_latest(self, like: Any) -> Optional[tuple]:
        """(tree, manifest) of the newest committed step, or None."""
        steps = self.steps()
        if not steps:
            return None
        return self._ckpt.restore(self._step_dir(steps[-1]), like)

    def restore(self, step: int, like: Any) -> tuple:
        return self._ckpt.restore(self._step_dir(step), like)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

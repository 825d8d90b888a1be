"""Sharded, resumable result store for large solve sweeps.

A numpy-only copy of ``mpc_mmd_tpu/utils/io_store.py`` with the same
manifest and chunk layout, so each package reads the other's stores (the
JAX module cannot be imported here: ``mpc_mmd_tpu/__init__.py`` imports
jax).  Results are written as fixed-size chunk shards with a JSON
manifest; re-running a sweep skips completed chunks (idempotent resume).

Multi-host: each process constructs the store with its own
``process_id`` and writes ONLY its own chunk shards and its own manifest
file (``manifest_p{pid}.json``), so no two processes ever write the same
file — no cross-host locking needed, any shared filesystem works.  Readers
(`iter_chunks` / `concatenated`) merge every process manifest present in
the root.  Chunk ownership is by convention ``cid % num_processes ==
process_id`` (the JAX package's mesh sweep follows it); the store itself
only enforces write-isolation.

Layout:
    <root>/manifest.json                  process 0 (single-process layout)
    <root>/manifest_p001.json             process 1's chunks
    <root>/chunk_00000.npz                arrays for configs [0, chunk)
    <root>/chunk_p001_00001.npz           process 1's chunk 1
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class ResultStore:
    # Meta keys that describe the sweep's EXTENT rather than the scenario
    # identity: a resumed sweep may legitimately grow them (config k's
    # chunk contents are seeded per config, independent of the total), so
    # they are excluded from the mix-refusal identity check and bumped to
    # the max seen on reopen.
    EXTENT_KEYS = ("num_configs",)

    def __init__(self, root: str, meta: Optional[dict] = None,
                 process_id: int = 0, num_processes: int = 1):
        if not (0 <= process_id < num_processes):
            raise ValueError(f"process_id {process_id} out of range for "
                             f"{num_processes} processes")
        self.root = root
        self.process_id = process_id
        self.num_processes = num_processes
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, self._manifest_name(process_id))
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self._manifest = json.load(f)
            prev = self._manifest.get("meta")
            if meta and prev is not None and \
                    self._meta_core(prev) != self._meta_core(meta):
                raise ValueError(
                    f"store at {root} was created with different meta "
                    f"({prev} != {meta}); refusing to mix")
            if meta and prev is not None:
                for k in self.EXTENT_KEYS:
                    if k in meta and meta[k] != prev.get(k):
                        prev[k] = max(meta[k], prev.get(k, meta[k]))
                        self._flush_manifest()
        else:
            self._manifest = {"meta": meta or {}, "chunks": {}}
            self._flush_manifest()
        # peer-manifest parse cache keyed by path -> (mtime_ns, manifest):
        # the sweep loop calls is_done() once per chunk, and re-parsing every
        # peer manifest JSON each time is O(n_chunks * n_processes) reads
        # over a (possibly shared/networked) filesystem.  mtime gating keeps
        # reads correct under concurrent peer writes (os.replace bumps mtime).
        self._peer_cache: Dict[str, Tuple[int, dict]] = {}

    @staticmethod
    def _manifest_name(pid: int) -> str:
        return "manifest.json" if pid == 0 else f"manifest_p{pid:03d}.json"

    @classmethod
    def _meta_core(cls, m: dict) -> dict:
        return {k: v for k, v in m.items() if k not in cls.EXTENT_KEYS}

    def _flush_manifest(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=1)
        os.replace(tmp, self._manifest_path)

    def _all_manifests(self) -> List[dict]:
        """Every process manifest in the root (self's in-memory copy plus
        peers' on disk), for merged reads."""
        out = [self._manifest]
        for path in sorted(glob.glob(os.path.join(self.root, "manifest*.json"))):
            if os.path.abspath(path) == os.path.abspath(self._manifest_path):
                continue
            mtime = os.stat(path).st_mtime_ns
            cached = self._peer_cache.get(path)
            if cached is not None and cached[0] == mtime:
                out.append(cached[1])
                continue
            with open(path) as f:
                m = json.load(f)
            if (m.get("meta") and self._manifest.get("meta")
                    and self._meta_core(m["meta"])
                    != self._meta_core(self._manifest["meta"])):
                raise ValueError(
                    f"peer manifest {path} holds different meta "
                    f"({m['meta']} != {self._manifest['meta']})")
            self._peer_cache[path] = (mtime, m)
            out.append(m)
        return out

    def owns(self, chunk_id: int) -> bool:
        """Chunk-ownership convention for multi-process sweeps."""
        return chunk_id % self.num_processes == self.process_id

    def done_chunks(self) -> List[int]:
        """All completed chunks across every process manifest."""
        done = set()
        for m in self._all_manifests():
            done.update(int(k) for k in m["chunks"])
        return sorted(done)

    def is_done(self, chunk_id: int) -> bool:
        if str(chunk_id) in self._manifest["chunks"]:
            return True
        return self.num_processes > 1 and chunk_id in self.done_chunks()

    def write_chunk(self, chunk_id: int, **arrays: np.ndarray) -> None:
        if not self.owns(chunk_id):
            raise ValueError(
                f"process {self.process_id}/{self.num_processes} does not "
                f"own chunk {chunk_id} (owner: "
                f"{chunk_id % self.num_processes})")
        prefix = "" if self.process_id == 0 else f"p{self.process_id:03d}_"
        name = f"chunk_{prefix}{chunk_id:05d}.npz"
        path = os.path.join(self.root, name)
        np.savez(path + ".tmp.npz", **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(path + ".tmp.npz", path)
        self._manifest["chunks"][str(chunk_id)] = name
        self._flush_manifest()

    def _chunk_name(self, chunk_id: int) -> str:
        for m in self._all_manifests():
            if str(chunk_id) in m["chunks"]:
                return m["chunks"][str(chunk_id)]
        raise KeyError(f"chunk {chunk_id} not in any manifest under {self.root}")

    def read_chunk(self, chunk_id: int) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.root, self._chunk_name(chunk_id))) as z:
            return {k: z[k] for k in z.files}

    def iter_chunks(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        for cid in self.done_chunks():
            yield cid, self.read_chunk(cid)

    def concatenated(self) -> Dict[str, np.ndarray]:
        """All chunks stacked along axis 0 (keys must match across chunks)."""
        out: Dict[str, List[np.ndarray]] = {}
        for _, arrays in self.iter_chunks():
            for k, v in arrays.items():
                out.setdefault(k, []).append(v)
        return {k: np.concatenate(v, axis=0) for k, v in out.items()}

    @property
    def meta(self) -> dict:
        return self._manifest["meta"]

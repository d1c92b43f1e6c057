"""Checkpoint / resume for sharded runs (port of
gencore_tpu/parallel/resume.py; same files, same fingerprint).

The reference is single-pass with no recovery: a crash reruns from
scratch. The shard decomposition gives natural recovery units: each
completed shard writes its output payload, its record keys and its
serialized stats plus a manifest entry; a resumed run skips the shards the
manifest lists whose files are all there, and merges.

Layout under <dir>/:
    manifest.json            {n_shards, fingerprint, completed: [..]}
    shard_<k>.payload        raw BAM payload (records with block_size prefixes)
    shard_<k>.keys.npy       bamComp sort keys of those records
    shard_<k>.stats.pkl      pickled (pre-partial, post) Stats

A directory written by the JAX package resumes here and the reverse: the
stats pickled there as gencore_tpu.stats.Stats load as this package's
Stats (the same class, copied), without importing that package.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle

import numpy as np

_SHARD_FILES = ("shard_{}.payload", "shard_{}.keys.npy", "shard_{}.stats.pkl")


class _StatsUnpickler(pickle.Unpickler):
    """Loads classes pickled under gencore_tpu.* from gencore_tpu_torch.*."""

    def find_class(self, module, name):
        if module == "gencore_tpu" or module.startswith("gencore_tpu."):
            module = "gencore_tpu_torch" + module[len("gencore_tpu"):]
        return super().find_class(module, name)


def options_fingerprint(opt) -> str:
    d = {f.name: getattr(opt, f.name) for f in opt.__dataclass_fields__.values()
         if f.name not in ("debug", "json_file", "html_file", "output")}
    return hashlib.sha256(json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()[:16]


class WindowCheckpoint:
    def __init__(self, directory: str, opt, n_shards: int):
        self.dir = directory
        self.n_shards = n_shards
        self.fp = options_fingerprint(opt)
        os.makedirs(directory, exist_ok=True)
        self.manifest_path = os.path.join(directory, "manifest.json")
        self.manifest = self._load()

    def _load(self) -> dict:
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                m = json.load(f)
            if m.get("fingerprint") == self.fp and m.get("n_shards") == self.n_shards:
                return m
        return {"fingerprint": self.fp, "n_shards": self.n_shards, "completed": []}

    def is_done(self, shard: int) -> bool:
        """Listed in the manifest and every file of the shard still there."""
        return (shard in self.manifest["completed"]
                and all(os.path.exists(os.path.join(self.dir, f.format(shard)))
                        for f in _SHARD_FILES))

    def record_shard(self, shard: int, payload: np.ndarray, rec_keys: np.ndarray,
                     pre_stats, post_stats):
        payload.tofile(os.path.join(self.dir, f"shard_{shard}.payload"))
        np.save(os.path.join(self.dir, f"shard_{shard}.keys.npy"), rec_keys)
        with open(os.path.join(self.dir, f"shard_{shard}.stats.pkl"), "wb") as f:
            pickle.dump((pre_stats, post_stats), f)
        self.manifest["completed"] = sorted(set(self.manifest["completed"]) | {shard})
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f)
        os.replace(tmp, self.manifest_path)

    def load_shard(self, shard: int):
        payload = np.fromfile(os.path.join(self.dir, f"shard_{shard}.payload"),
                              dtype=np.uint8)
        keys = np.load(os.path.join(self.dir, f"shard_{shard}.keys.npy"))
        with open(os.path.join(self.dir, f"shard_{shard}.stats.pkl"), "rb") as f:
            pre, post = _StatsUnpickler(f).load()
        return payload, keys, pre, post

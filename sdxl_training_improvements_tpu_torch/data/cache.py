"""Disk cache for VAE latents + CLIP embeddings (host-side, numpy/npz).

Functional counterpart of the reference ``CacheManager``
(``src/data/preprocessing/cache_manager.py``), keeping its layout and
semantics — MD5-of-path keys (``:726-729``), ``cache/latents/{vae,clip,
metadata}`` + ``cache/tags`` tree (``:62-81``), zlib-compressed JSON index
with atomic tmp+rename writes (``:613-699``), full rebuild from a disk scan
(``:110-245``), verification with pruning (``:837-941``) — re-designed for
a pipeline that both packages share (this module is a copy of the JAX
package's ``data/cache.py``, so a cache written by either feeds the other):

* tensors are stored as ``.npz`` numpy archives (framework-neutral, mmap-able)
  instead of torch ``.pt`` pickles;
* the index is only rewritten every ``index_save_every`` inserts + on
  ``flush()`` (the reference rewrote the full index per image — flagged HOT
  in SURVEY.md §3.4);
* loads return numpy arrays, stacked into batches on the host.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import zlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

INDEX_NAME = "cache_index.json.zlib"


def _atomic_write(path: Path, write_tmp) -> None:
    """tmp-file + os.replace atomicity, shared by every cache artifact
    (npz tensors, metadata JSON, tag index, compressed index)."""
    tmp = path.with_name(path.name + ".tmp")
    write_tmp(tmp)
    os.replace(tmp, path)


def _portable(arr) -> np.ndarray:
    """Coerce to an npz-round-trippable numpy dtype.

    bf16 encoders produce ml_dtypes.bfloat16 arrays; np.savez writes their
    raw bytes but np.load reads them back as void ``|V2`` — a permanently
    poisoned cache entry that crashes device_put at batch time.  Cache
    storage is float32 for such dtypes (bf16 values are exact in fp32;
    the train step re-casts to its compute dtype anyway)."""
    arr = np.asarray(arr)
    if arr.dtype.kind not in "fiub" or arr.dtype.name == "bfloat16":
        return arr.astype(np.float32)
    return arr


def _atomic_npz(path: Path, **arrs) -> None:
    # np.savez appends ".npz" to bare paths; hand it an open file object so
    # the tmp name is exactly what os.replace moves
    def write(tmp: Path) -> None:
        with open(tmp, "wb") as f:
            np.savez(f, **arrs)

    _atomic_write(path, write)


class CacheManager:
    def __init__(self, cache_dir, index_save_every: int = 256):
        self.cache_dir = Path(cache_dir)
        self.vae_dir = self.cache_dir / "latents" / "vae"
        self.clip_dir = self.cache_dir / "latents" / "clip"
        self.meta_dir = self.cache_dir / "latents" / "metadata"
        self.tags_dir = self.cache_dir / "tags"
        for d in (self.vae_dir, self.clip_dir, self.meta_dir, self.tags_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.index_path = self.cache_dir / INDEX_NAME
        self._lock = threading.Lock()
        self._dirty = 0
        self.index_save_every = index_save_every
        self.index: Dict[str, dict] = self._load_index()

    # ----------------------------------------------------------------- keys
    @staticmethod
    def get_cache_key(path) -> str:
        """MD5 of the (posix-normalised) path — reference ``:726-729``."""
        return hashlib.md5(str(Path(path).as_posix()).encode()).hexdigest()

    # ---------------------------------------------------------------- index
    def _load_index(self) -> Dict[str, dict]:
        if not self.index_path.exists():
            # fresh dir -> empty; missing index over existing data -> rescan
            return self.rebuild_index() if any(self.vae_dir.glob("*.npz")) else {}
        try:
            blob = self.index_path.read_bytes()
            return json.loads(zlib.decompress(blob).decode())
        except Exception:
            return self.rebuild_index()

    def _save_index_locked(self) -> None:
        blob = zlib.compress(json.dumps(self.index).encode())
        _atomic_write(self.index_path, lambda tmp: tmp.write_bytes(blob))
        self._dirty = 0

    def flush(self) -> None:
        with self._lock:
            self._save_index_locked()

    def rebuild_index(self) -> Dict[str, dict]:
        """Disk scan -> fresh index (reference ``rebuild_cache_index``)."""
        index: Dict[str, dict] = {}
        for npz in self.vae_dir.glob("*.npz"):
            key = npz.stem
            entry: dict = {"vae": True}
            meta_path = self.meta_dir / f"{key}.json"
            if meta_path.exists():
                try:
                    entry.update(json.loads(meta_path.read_text()))
                except Exception:
                    pass
            entry["clip"] = (self.clip_dir / f"{key}.npz").exists()
            index[key] = entry
        with self._lock:
            self.index = index
            self._save_index_locked()
        return index

    # ---------------------------------------------------------------- save
    def save_latents(self, key: str, *, vae_latents: np.ndarray,
                     time_ids: np.ndarray,
                     prompt_embeds: Optional[np.ndarray] = None,
                     pooled_prompt_embeds: Optional[np.ndarray] = None,
                     metadata: Optional[dict] = None) -> None:
        """Atomic npz + metadata + (batched) index update
        (reference ``save_latents`` ``:289-402``)."""
        has_clip = prompt_embeds is not None
        if has_clip and pooled_prompt_embeds is None:
            # np.savez would silently pickle the None into an object array
            # that allow_pickle=False loads can never read back — the entry
            # would be permanently poisoned while the index says clip=True
            raise ValueError(
                "save_latents: prompt_embeds given without "
                "pooled_prompt_embeds (both or neither)")
        _atomic_npz(self.vae_dir / f"{key}.npz",
                    vae_latents=_portable(vae_latents),
                    time_ids=_portable(time_ids))
        if has_clip:
            _atomic_npz(self.clip_dir / f"{key}.npz",
                        prompt_embeds=_portable(prompt_embeds),
                        pooled_prompt_embeds=_portable(pooled_prompt_embeds))
        meta = dict(metadata or {})
        meta_path = self.meta_dir / f"{key}.json"
        _atomic_write(meta_path, lambda tmp: tmp.write_text(json.dumps(meta)))

        with self._lock:
            entry = {"vae": True, "clip": has_clip, **meta}
            entry["latent_shape"] = list(np.asarray(vae_latents).shape)
            self.index[key] = entry
            self._dirty += 1
            if self._dirty >= self.index_save_every:
                self._save_index_locked()

    # ---------------------------------------------------------------- load
    def load_latents(self, key: str) -> Optional[dict]:
        """Returns {vae_latents, time_ids, prompt_embeds?, pooled?, metadata}
        as numpy arrays, or None on miss (reference ``load_tensors``)."""
        vae_path = self.vae_dir / f"{key}.npz"
        if not vae_path.exists():
            return None
        try:
            out: dict = {}
            with np.load(vae_path) as z:
                out["vae_latents"] = z["vae_latents"]
                out["time_ids"] = z["time_ids"]
            clip_path = self.clip_dir / f"{key}.npz"
            if clip_path.exists():
                with np.load(clip_path) as z:
                    out["prompt_embeds"] = z["prompt_embeds"]
                    out["pooled_prompt_embeds"] = z["pooled_prompt_embeds"]
            for v in out.values():
                if v.dtype.kind not in "fiub":
                    # entry written by a pre-round-3 build with bf16
                    # encoders: npz read it back as void — treat as a miss
                    # so precompute/verify re-encodes it (see _portable)
                    return None
            meta_path = self.meta_dir / f"{key}.json"
            out["metadata"] = (json.loads(meta_path.read_text())
                               if meta_path.exists() else {})
            return out
        except Exception:
            return None

    # ------------------------------------------------------------- queries
    def is_cached(self, path, require_clip: bool = True) -> bool:
        key = self.get_cache_key(path)
        entry = self.index.get(key)
        if entry is None:
            return False
        return entry.get("vae", False) and (entry.get("clip", False)
                                            or not require_clip)

    def get_uncached_paths(self, paths: Iterable, require_clip: bool = True
                           ) -> List:
        """Paths missing from the cache (reference ``:247-287``)."""
        return [p for p in paths if not self.is_cached(p, require_clip)]

    def cached_entry(self, path) -> Optional[dict]:
        return self.index.get(self.get_cache_key(path))

    # -------------------------------------------------------------- verify
    def verify_and_prune(self) -> Tuple[int, int]:
        """Check files behind every index entry; drop broken ones.
        Returns (valid, pruned) — reference ``verify_and_rebuild_cache``."""
        # validate OUTSIDE the lock (a whole-cache read can take minutes on
        # large caches; concurrent save_latents must not block on it), then
        # prune under the lock
        with self._lock:
            keys = list(self.index)
            clip_flags = {k: self.index[k].get("clip") for k in keys}
        bad = {}  # key -> vae-file mtime_ns observed at validation (or None)
        for key in keys:
            vae_path = self.vae_dir / f"{key}.npz"
            try:
                mtime = vae_path.stat().st_mtime_ns
            except OSError:
                mtime = None
            ok = mtime is not None
            if ok and clip_flags[key]:
                ok = (self.clip_dir / f"{key}.npz").exists()
            if ok:
                try:
                    with np.load(vae_path) as z:
                        _ = z["vae_latents"].shape
                except Exception:
                    ok = False
            if not ok:
                bad[key] = mtime
        with self._lock:
            pruned = 0
            for key, seen_mtime in bad.items():
                # a concurrent save_latents may have (re)written this entry
                # between the snapshot validation above and now — the writes
                # are atomic replaces, so a changed/appeared mtime means a
                # fresh valid entry that must NOT be pruned
                try:
                    cur_mtime = (self.vae_dir / f"{key}.npz").stat().st_mtime_ns
                except OSError:
                    cur_mtime = None
                if cur_mtime is not None and cur_mtime != seen_mtime:
                    continue
                if self.index.pop(key, None) is not None:
                    pruned += 1
                for d, suffix in ((self.vae_dir, ".npz"),
                                  (self.clip_dir, ".npz"),
                                  (self.meta_dir, ".json")):
                    f = d / f"{key}{suffix}"
                    if f.exists():
                        f.unlink()
            valid = len(self.index)
            self._save_index_locked()
        return valid, pruned

    # ------------------------------------------------------------ cfg-dropout
    def save_empty_prompt(self, prompt_embeds: np.ndarray,
                          pooled_prompt_embeds: np.ndarray) -> None:
        """Cache the empty-caption CLIP embedding (classifier-free-guidance
        dropout support)."""
        _atomic_npz(self.clip_dir / "__empty_prompt__.npz",
                    prompt_embeds=prompt_embeds,
                    pooled_prompt_embeds=pooled_prompt_embeds)

    def load_empty_prompt(self) -> Optional[dict]:
        path = self.clip_dir / "__empty_prompt__.npz"
        if not path.exists():
            return None
        try:
            with np.load(path) as z:
                return {"prompt_embeds": z["prompt_embeds"],
                        "pooled_prompt_embeds": z["pooled_prompt_embeds"]}
        except Exception:
            return None

    # ----------------------------------------------------------------- tags
    def save_tag_index(self, data: dict) -> None:
        _atomic_write(self.tags_dir / "tag_index.json",
                      lambda tmp: tmp.write_text(json.dumps(data)))

    def load_tag_index(self) -> Optional[dict]:
        p = self.tags_dir / "tag_index.json"
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())
        except Exception:
            return None

    # pickling (dataloader workers): drop the lock like the reference ``:95-108``
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_lock")
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

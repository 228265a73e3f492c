"""Aspect-ratio bucketing (host-side, pure python/numpy).

Re-implements the reference bucket system (``src/data/preprocessing/
bucket_types.py`` + ``bucket_utils.py``) with identical semantics:

* dims rounded to /8, latent dims = /8 (``bucket_types.py:18-40``);
* generation = common SDXL sizes first, then a min->max step-64 grid
  filtered by max aspect ratio, sorted by (pixels, AR) and deduplicated at
  10% size / 0.1 AR similarity (``bucket_utils.py:17-109``);
* assignment = weighted size/aspect scoring with tolerances (0.3, 0.15),
  size weight 0.7 when size_diff > 0.2 else 0.5, closest-AR fallback
  (``bucket_utils.py:111-167``);
* validation with 10% min/max tolerance and 1.2x AR tolerance
  (``bucket_utils.py:305-355``).

A copy of the JAX package's ``data/buckets.py`` (numpy and the standard
library only), so both packages bucket a dataset the same way.  Each
distinct latent (H, W) is one batch shape of the train step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

COMMON_SIZES: Tuple[Tuple[int, int], ...] = (
    (1024, 1024), (1024, 1536), (1536, 1024), (1024, 1280), (1280, 1024),
    (1152, 896), (896, 1152), (1216, 832), (832, 1216), (1152, 1152),
    (1280, 1536), (1536, 1280), (1408, 1024), (1024, 1408),
)


@dataclass(frozen=True)
class Bucket:
    """One (width, height) training resolution; ``index`` is its id."""

    width: int
    height: int
    index: int = 0

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"Invalid dimensions: {self.width}x{self.height}")

    @classmethod
    def from_dims(cls, width: int, height: int, index: int = 0) -> "Bucket":
        return cls(((width + 7) // 8) * 8, ((height + 7) // 8) * 8, index)

    @property
    def pixel_dims(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def latent_dims(self) -> Tuple[int, int]:
        return (self.width // 8, self.height // 8)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def total_pixels(self) -> int:
        return self.width * self.height

    @property
    def total_latents(self) -> int:
        return (self.width // 8) * (self.height // 8)

    @property
    def size_class(self) -> str:
        px = self.total_pixels
        if px <= 640 * 640:
            return "small"
        if px <= 1024 * 1024:
            return "medium"
        return "large"

    @property
    def aspect_class(self) -> str:
        ar = self.aspect_ratio
        if 0.95 <= ar <= 1.05:
            return "square"
        return "landscape" if ar > 1 else "portrait"

    def to_dict(self) -> dict:
        return {"width": self.width, "height": self.height, "index": self.index}

    @classmethod
    def from_dict(cls, d: dict) -> "Bucket":
        return cls(d["width"], d["height"], d.get("index", 0))


def validate_bucket(bucket: Bucket, image_config) -> Tuple[bool, Optional[str]]:
    """Constraint check with the reference's tolerances
    (10% size slack, 1.2x AR slack — ``bucket_utils.py:305-355``)."""
    w, h = bucket.pixel_dims
    min_w, min_h = image_config.min_size
    max_w, max_h = image_config.max_size
    tol = 0.1
    min_w, min_h = int(min_w * (1 - tol)), int(min_h * (1 - tol))
    max_w, max_h = int(max_w * (1 + tol)), int(max_h * (1 + tol))
    if not (min_w <= w <= max_w):
        return False, f"Width {w} outside allowed range {min_w}-{max_w}"
    if not (min_h <= h <= max_h):
        return False, f"Height {h} outside allowed range {min_h}-{max_h}"
    if w % 8 or h % 8:
        return False, f"Dimensions must be divisible by 8: {w}x{h}"
    max_ratio = image_config.max_aspect_ratio * 1.2
    ratio = w / h
    if not (1 / max_ratio <= ratio <= max_ratio):
        return False, f"Aspect ratio {ratio:.2f} outside allowed range"
    return True, None


def generate_buckets(config) -> List[Bucket]:
    """Common sizes + step-64 grid, validated, sorted, deduplicated."""
    image_config = config.global_config.image
    min_w, min_h = image_config.min_size
    max_w, max_h = image_config.max_size
    step = image_config.bucket_step or 64

    buckets: List[Bucket] = []

    def try_add(w: int, h: int):
        if any(b.pixel_dims == (w, h) for b in buckets):
            return
        b = Bucket.from_dims(w, h, len(buckets))
        ok, _ = validate_bucket(b, image_config)
        if ok:
            buckets.append(b)

    for w, h in COMMON_SIZES:
        try_add(w, h)

    max_ratio = image_config.max_aspect_ratio
    for w in range(min_w, max_w + 1, step):
        for h in range(min_h, max_h + 1, step):
            ratio = w / h
            if not (1 / max_ratio <= ratio <= max_ratio):
                continue
            try_add(w, h)

    buckets.sort(key=lambda b: (b.total_pixels, b.aspect_ratio))

    filtered: List[Bucket] = []
    for b in buckets:
        unique = True
        for e in filtered:
            size_diff = abs(b.total_pixels - e.total_pixels) / b.total_pixels
            aspect_diff = abs(b.aspect_ratio - e.aspect_ratio)
            if size_diff < 0.1 and aspect_diff < 0.1:
                unique = False
                break
        if unique:
            filtered.append(b)
    # re-index after filtering
    return [Bucket(b.width, b.height, i) for i, b in enumerate(filtered)]


def supported_dims_buckets(config) -> List[Bucket]:
    """Buckets straight from ``image.supported_dims`` (the bounded set the
    compile cache is keyed on; generation above is the open-world variant)."""
    return [Bucket.from_dims(w, h, i)
            for i, (w, h) in enumerate(config.global_config.image.supported_dims)]


def assign_bucket(original_size: Tuple[int, int], buckets: Sequence[Bucket],
                  max_size_diff: float = 0.3,
                  max_aspect_diff: float = 0.15) -> Optional[Bucket]:
    """Weighted scoring (``bucket_utils.py:111-167``)."""
    if not buckets:
        return None
    w, h = original_size
    if w <= 0 or h <= 0:
        return None
    ratio, pixels = w / h, w * h

    best, best_score = None, float("inf")
    for b in buckets:
        size_diff = abs(b.total_pixels - pixels) / pixels
        aspect_diff = abs(b.aspect_ratio - ratio)
        if aspect_diff > 1:  # reciprocal aspect tolerance
            aspect_diff = abs(1 / b.aspect_ratio - ratio)
        size_weight = 0.7 if size_diff > 0.2 else 0.5
        if size_diff <= max_size_diff and aspect_diff <= max_aspect_diff:
            score = size_diff * size_weight + aspect_diff * (1.0 - size_weight)
            if score < best_score:
                best, best_score = b, score
    if best is None:
        best = min(buckets, key=lambda b: abs(b.aspect_ratio - ratio))
    return best


def group_images_by_bucket(image_sizes: Dict[str, Tuple[int, int]],
                           buckets: Sequence[Bucket]
                           ) -> Dict[Tuple[int, int], List[str]]:
    """Map latent (h, w) -> image paths (``bucket_utils.py:169-270``;
    sizes come from the cache index or the PNG headers upstream)."""
    groups: Dict[Tuple[int, int], List[str]] = {}
    for path, size in image_sizes.items():
        b = assign_bucket(size, buckets)
        if b is None:
            continue
        lw, lh = b.latent_dims
        groups.setdefault((lh, lw), []).append(path)
    return groups


def bucket_statistics(groups: Dict[Tuple[int, int], List[str]]) -> dict:
    total = sum(len(v) for v in groups.values())
    return {
        "total_images": total,
        "num_buckets": len(groups),
        "bucket_counts": {f"{k[1]*8}x{k[0]*8}": len(v)
                          for k, v in sorted(groups.items())},
    }

"""Tag-based loss weighting (host-side, pure python/numpy).

Counterpart of the reference ``TagWeighter`` (``src/data/preprocessing/
tag_weighter.py``): captions are comma-separated tag lists, each tag is
categorized into {subject, style, quality, technical, meta}, per-tag weights
are smoothed inverse frequencies clamped to [min, max] (``:411-449``), and a
caption's weight is the geometric mean of the per-category mean weights
(``:451-482``).  Weights reach the loss as ``batch["tag_weights"]``
(``ddpm_trainer.py:347-368`` / ``methods._apply_tag_weights``).

The reference categorizes with spaCy NLP (``:171-235``); this rebuild
deliberately replaces that with the pure-python heuristic keyword/pattern
categorizer below (same explicit ``category:`` prefixes and the common
quality/technical/style vocabularies the reference special-cases) — no spaCy
dependency, no spaCy code path.

Weight-formula note: the reference contains TWO caption-weight formulas —
the trainer-side arithmetic mean of raw tag weights
(``ddpm_trainer.py:347-368``) and ``get_caption_weight``'s geometric mean of
per-category means (``tag_weighter.py:451-482``).  This rebuild feeds the
loss the geometric-mean formula (the one the reference's TagWeighter itself
documents as the caption weight); chosen deliberately, covered by golden
tests in ``tests/test_data.py::TestTags``.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

TAG_TYPES = ("subject", "style", "quality", "technical", "meta")

_QUALITY_WORDS = {
    "masterpiece", "best quality", "high quality", "low quality", "worst quality",
    "hires", "highres", "lowres", "absurdres", "detailed", "ultra detailed",
    "sharp", "blurry", "jpeg artifacts", "noisy", "hdr",
}
_TECHNICAL_PAT = re.compile(
    r"(^\d+(k|p|fps|mm|bit)$)|(^f/\d)|(bokeh|depth of field|long exposure|"
    r"macro|wide angle|fisheye|telephoto|iso \d+|aperture|shutter)")
_STYLE_PAT = re.compile(
    r"(style|art|painting|sketch|drawing|render|illustration|watercolor|"
    r"oil|pastel|anime|cartoon|realistic|photorealistic|pixel|chibi|"
    r"monochrome|grayscale|sepia|film grain|3d|cgi|digital)")
_META_PAT = re.compile(
    r"(commentary|request|translated|artist name|signature|watermark|"
    r"username|dated|page number|cover|sample|duplicate)")


def categorize_tag(tag: str) -> str:
    """Heuristic category for one tag (reference ``_get_tag_category``)."""
    tag = tag.lower().strip()
    if ":" in tag:
        prefix = tag.split(":", 1)[0].strip()
        if prefix in TAG_TYPES:
            return prefix
    clean = tag.replace("_", " ").strip()
    if clean in _QUALITY_WORDS or any(q in clean for q in
                                      ("quality", "res", "resolution")):
        return "quality"
    if _TECHNICAL_PAT.search(clean):
        return "technical"
    if _META_PAT.search(clean):
        return "meta"
    if _STYLE_PAT.search(clean):
        return "style"
    return "subject"


def extract_tags(caption: str) -> Dict[str, List[str]]:
    """Split a comma-separated caption into categorized tags
    (reference ``_extract_tags`` ``:896-942``)."""
    out: Dict[str, List[str]] = {t: [] for t in TAG_TYPES}
    for raw in caption.split(","):
        tag = raw.strip()
        if not tag:
            continue
        cat = categorize_tag(tag)
        if ":" in tag and tag.split(":", 1)[0].strip() in TAG_TYPES:
            tag = tag.split(":", 1)[1].strip()
        out[cat].append(tag.lower())
    return out


class TagWeighter:
    def __init__(self, min_weight: float = 0.1, max_weight: float = 3.0,
                 default_weight: float = 1.0, smoothing_factor: float = 0.05):
        if min_weight <= 0 or max_weight < min_weight:
            raise ValueError(f"invalid weight range [{min_weight}, {max_weight}]")
        self.min_weight = min_weight
        self.max_weight = max_weight
        self.default_weight = default_weight
        self.smoothing_factor = smoothing_factor
        self.tag_counts: Dict[str, Dict[str, int]] = {
            t: defaultdict(int) for t in TAG_TYPES}
        self.tag_weights: Dict[str, Dict[str, float]] = {
            t: defaultdict(lambda: default_weight) for t in TAG_TYPES}

    # ------------------------------------------------------------ building
    def update_statistics(self, captions) -> None:
        for caption in captions:
            for cat, tags in extract_tags(caption).items():
                for tag in tags:
                    self.tag_counts[cat][tag] += 1
        self._compute_weights()

    def _compute_weights(self) -> None:
        """Smoothed inverse-frequency weights, clamped (reference ``:411-449``):
        w = clamp(min_w + ((1/(freq + s)) - 1)/(1/s - 1) * (max_w - min_w))."""
        min_max_diff = self.max_weight - self.min_weight
        weight_range = 1.0 / self.smoothing_factor - 1.0
        for cat, counts in self.tag_counts.items():
            if not counts:
                continue
            tags = list(counts)
            c = np.array([counts[t] for t in tags], dtype=np.float32)
            freq = c / c.sum()
            w = self.min_weight + ((1.0 / (freq + self.smoothing_factor)) - 1.0) \
                / weight_range * min_max_diff
            w = np.clip(w, self.min_weight, self.max_weight)
            for tag, weight in zip(tags, w.tolist()):
                self.tag_weights[cat][tag] = weight

    # ------------------------------------------------------------- queries
    def get_caption_weight(self, caption: str) -> float:
        """Geometric mean of per-category mean tag weights (``:451-482``)."""
        cat_means = []
        for cat, tags in extract_tags(caption).items():
            if not tags:
                continue
            uniq = set(tags)
            weights = np.array([self.tag_weights[cat][t] for t in uniq],
                               dtype=np.float32)
            if len(weights):
                cat_means.append(float(weights.mean()))
        if not cat_means:
            return self.default_weight
        arr = np.array(cat_means, dtype=np.float32)
        return float(np.exp(np.mean(np.log(arr))))

    def get_batch_weights(self, captions) -> np.ndarray:
        return np.array([self.get_caption_weight(c) for c in captions],
                        dtype=np.float32)

    # --------------------------------------------------------------- cache
    def to_index(self) -> dict:
        return {
            "config": {"min_weight": self.min_weight,
                       "max_weight": self.max_weight,
                       "default_weight": self.default_weight,
                       "smoothing_factor": self.smoothing_factor},
            "counts": {c: dict(d) for c, d in self.tag_counts.items()},
            "weights": {c: dict(d) for c, d in self.tag_weights.items()},
        }

    @classmethod
    def from_index(cls, data: dict) -> "TagWeighter":
        tw = cls(**data.get("config", {}))
        for cat, counts in data.get("counts", {}).items():
            tw.tag_counts[cat].update(counts)
        for cat, weights in data.get("weights", {}).items():
            tw.tag_weights[cat].update(weights)
        return tw


def create_tag_weighter_with_index(config, captions, cache_manager=None
                                   ) -> Optional[TagWeighter]:
    """Build (or load cached) weighter from the config surface
    (reference ``create_tag_weighter_with_index`` ``:966-1011``)."""
    twc = config.tag_weighting
    if not twc.enable_tag_weighting:
        return None
    if cache_manager is not None and twc.use_cache:
        cached = cache_manager.load_tag_index()
        if cached:
            return TagWeighter.from_index(cached)
    tw = TagWeighter(min_weight=twc.min_weight, max_weight=twc.max_weight,
                     default_weight=twc.default_weight,
                     smoothing_factor=twc.smoothing_factor)
    tw.update_statistics(captions)
    if cache_manager is not None and twc.use_cache:
        cache_manager.save_tag_index(tw.to_index())
    return tw

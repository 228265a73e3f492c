"""Dataset discovery + path utilities.

Counterpart of reference ``src/data/utils/paths.py`` and
``src/core/utils/paths.py``: glob image files across one or more directories
with sibling ``.txt`` captions, plus Windows/WSL path conversion so configs
written on Windows (the reference ships ``D:\\...`` paths in its default
config) load anywhere.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import List, Sequence, Tuple, Union

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".webp")

_WIN_PATH = re.compile(r"^[A-Za-z]:[\\/]")


def is_windows_path(path: str) -> bool:
    return bool(_WIN_PATH.match(str(path)))


def convert_windows_path(path: Union[str, Path]) -> Path:
    """``C:\\x\\y`` -> ``/mnt/c/x/y`` (reference ``core/utils/paths.py:17-45``)."""
    s = str(path)
    if not is_windows_path(s):
        return Path(s)
    drive = s[0].lower()
    rest = s[2:].replace("\\", "/").lstrip("/")
    return Path(f"/mnt/{drive}/{rest}")


def load_data_from_directory(train_dirs: Union[str, Sequence[str]]
                             ) -> Tuple[List[str], List[str]]:
    """(image_paths, captions) with sibling ``.txt`` captions
    (reference ``data/utils/paths.py:20-64``).  Images without a caption file
    get an empty caption rather than being dropped."""
    if isinstance(train_dirs, (str, Path)):
        train_dirs = [train_dirs]
    image_paths: List[str] = []
    captions: List[str] = []
    for d in train_dirs:
        root = convert_windows_path(d)
        if not root.exists():
            continue
        files = sorted(p for p in root.rglob("*")
                       if p.suffix.lower() in IMAGE_EXTENSIONS)
        for p in files:
            txt = p.with_suffix(".txt")
            caption = ""
            if txt.exists():
                try:
                    caption = txt.read_text(encoding="utf-8",
                                            errors="replace").strip()
                except OSError:
                    caption = ""
            image_paths.append(str(p))
            captions.append(caption)
    return image_paths, captions

"""Training-subset list loaders (counterpart of
mivos_tpu/utils/load_subset.py; reference util/load_subset.py).

The subset files are newline-separated video names shipped with the
datasets (the reference bundles util/davis_subset.txt /
util/yv_subset.txt — the DAVIS/YouTubeVOS training splits minus
validation overlap)."""
from __future__ import annotations

from typing import Set


def load_subset(path: str) -> Set[str]:
    with open(path) as f:
        return set(f.read().splitlines())


# Reference API names (load_subset.py:1-11).
load_sub_davis = load_subset
load_sub_yv = load_subset

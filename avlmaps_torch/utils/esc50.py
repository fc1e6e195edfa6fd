"""ESC-50 metadata access (counterpart of ``avlmaps_tpu/utils/esc50.py``;
reference avlmaps/utils/esc50_utils.py:8-62).

Parses the dataset's ``esc50.csv`` into category <-> clip-path lookups,
restricted to one fold (fold 1, as the reference does).
"""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path
from typing import Dict, List


class ESC50Meta:
    def __init__(self, meta_path: str, audio_dir: str, fold: int = 1):
        self.meta_path = Path(meta_path)
        self.audio_dir = Path(audio_dir)
        self.fold = fold
        self.category_to_paths: Dict[str, List[Path]] = defaultdict(list)
        self.path_to_category: Dict[str, str] = {}
        with open(self.meta_path, newline="") as f:
            for row in csv.DictReader(f):
                if int(row["fold"]) != self.fold:
                    continue
                path = self.audio_dir / row["filename"]
                self.category_to_paths[row["category"]].append(path)
                self.path_to_category[str(path)] = row["category"]

    @property
    def categories(self) -> List[str]:
        return sorted(self.category_to_paths)

    def paths_for(self, category: str) -> List[Path]:
        return self.category_to_paths.get(category, [])

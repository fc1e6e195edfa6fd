"""Category name resolution.

Counterpart of ``avlmaps_tpu/utils/category_matching.py``.  The reference
resolves unknown names with an OpenAI text-davinci-002 call
(avlmaps/utils/index_utils.py:8-32).  Here the exact match comes first,
then an injectable resolver, then the LLM of ``utils/llm`` when an OpenAI
key is set (any error of it falls through, as in the JAX package), then a
fuzzy string match, so a query never fails offline.
"""

from __future__ import annotations

import difflib
import os
from typing import Callable, List, Optional

# injectable resolver: fn(class_name, classes_list) -> resolved name
llm_resolver: Optional[Callable[[str, List[str]], str]] = None


def find_similar_category_id(class_name: str,
                             classes_list: List[str]) -> int:
    """Index of the most similar category (reference index_utils.py:8-32)."""
    if class_name in classes_list:
        return classes_list.index(class_name)
    if llm_resolver is not None:
        result = llm_resolver(class_name, classes_list)
        if result in classes_list:
            return classes_list.index(result)
    if os.environ.get("OPENAI_KEY") or os.environ.get("OPENAI_API_KEY"):
        try:
            from avlmaps_torch.utils.llm import parse_similar_category

            result = parse_similar_category(class_name, classes_list)
            if result in classes_list:
                return classes_list.index(result)
        except Exception:
            pass
    # offline fallback: closest string match
    match = difflib.get_close_matches(class_name, classes_list, n=1,
                                      cutoff=0.0)
    return classes_list.index(match[0]) if match else 0

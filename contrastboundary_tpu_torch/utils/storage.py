"""Container reshaping (counterpart of contrastboundary_tpu/utils/storage.py)."""
from __future__ import annotations

from typing import Dict, List


def dict_list(list_of_dicts: List[dict]) -> Dict[str, list]:
    """[{k: v}, ...] → {k: [v, ...]}; the keys are the first element's."""
    if not list_of_dicts:
        return {}
    return {k: [d[k] for d in list_of_dicts] for k in list_of_dicts[0]}


def list_dict(dict_of_lists: Dict[str, list]) -> List[dict]:
    """{k: [v, ...]} → [{k: v}, ...]."""
    if not dict_of_lists:
        return []
    n = len(next(iter(dict_of_lists.values())))
    return [{k: v[i] for k, v in dict_of_lists.items()} for i in range(n)]

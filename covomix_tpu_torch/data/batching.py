"""Length bucketing of variable-length items into batches (the port's own
numpy copy of `covomix_tpu.native.batch_by_size`, whose C++ helper and
Python fallback give the same batches as this)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def batch_by_size(lengths: Sequence[int], max_tokens: int = 0, max_sentences: int = 0) -> list:
    """Items sorted by length (stable), cut greedily into batches (fairseq
    data_utils_fast semantics): a batch closes before the item that would
    take it past `max_sentences` rows or past `max_tokens` = longest length
    x rows (0: no limit). A single item longer than `max_tokens` is a batch
    of its own. Returns a list of int64 index arrays."""
    lengths = np.asarray(lengths, dtype=np.int64)
    batches, cur, max_len = [], [], 0
    for idx in np.argsort(lengths, kind="stable"):
        new_max = max(max_len, int(lengths[idx]))
        rows = len(cur) + 1
        if cur and ((max_sentences and rows > max_sentences) or (max_tokens and new_max * rows > max_tokens)):
            batches.append(np.asarray(cur, np.int64))
            cur, max_len = [int(idx)], int(lengths[idx])
        else:
            cur.append(int(idx))
            max_len = new_max
    if cur:
        batches.append(np.asarray(cur, np.int64))
    return batches

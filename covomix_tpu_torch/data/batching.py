"""Length bucketing of variable-length items into batches, and token-block
slicing of a flattened token stream (the port's own numpy copies of
`covomix_tpu.native.batch_by_size`, `token_block_slices` and
`block_to_dataset_index`, whose C++ helpers and Python fallbacks give the
same results as these)."""

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


_BREAK_MODES = {None: 0, "none": 0, "complete": 1, "complete_doc": 2, "eos": 3}


def token_block_slices(sizes, block_size: int, break_mode: str = "none", document_sep_len: int = 1) -> np.ndarray:
    """[start, end) slices of the flattened token stream, one per block
    (fairseq token_block_utils semantics), int64 [num_blocks, 2].
    break_mode: 'none' (fixed block_size chunks), 'complete' (whole sentences
    packed up to block_size), 'complete_doc' (as 'complete', documents
    delimited by rows of document_sep_len tokens; blocks of one token
    dropped), 'eos' (one slice per sentence)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if break_mode not in _BREAK_MODES:
        raise ValueError(f"Invalid break_mode: {break_mode}")
    mode = _BREAK_MODES[break_mode]
    if mode == 0:
        total = int(sizes.sum())
        if not total:
            return np.zeros((0, 2), np.int64)
        starts = np.arange(0, total, int(block_size), dtype=np.int64)
        return np.stack([starts, np.minimum(starts + int(block_size), total)], axis=1)
    if mode == 3:
        cum = np.concatenate([[0], np.cumsum(sizes)])
        return np.stack([cum[:-1], cum[1:]], axis=1)
    out, tok, cur, i = [], 0, 0, 0
    min_keep = 2 if mode == 2 else 1
    while i < len(sizes):
        doc_sep = mode == 2 and sizes[i] == document_sep_len
        if (cur + sizes[i] <= block_size or cur == 0) and not doc_sep:
            cur += int(sizes[i])
            i += 1
        else:
            if cur >= min_keep:
                out.append((tok, tok + cur))
            tok += cur
            cur = 0
            if doc_sep:
                tok += int(sizes[i])
                i += 1
    if cur >= min_keep:
        out.append((tok, tok + cur))
    return np.asarray(out, np.int64).reshape(-1, 2)


def block_to_dataset_index(sizes, slice_indices) -> np.ndarray:
    """Per block (start_ds_idx, start_offset, end_ds_idx) into the
    per-sequence dataset, int64 [num_blocks, 3]. A flat index on a sequence
    boundary belongs to the first sequence that starts there (zero-length
    ones included)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    sl = np.asarray(slice_indices, dtype=np.int64).reshape(-1, 2)
    cum = np.concatenate([[0], np.cumsum(sizes)])

    def find(flat):
        i = int(np.searchsorted(cum, flat, side="left"))
        return i if i < len(cum) - 1 and cum[i] == flat else i - 1

    out = []
    for s, e in sl:
        sd = find(s)
        out.append((sd, int(s) - int(cum[sd]), sd if e <= s else find(e - 1)))
    return np.asarray(out, np.int64).reshape(-1, 3)

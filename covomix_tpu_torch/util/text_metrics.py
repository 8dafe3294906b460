"""Token-sequence metrics of the T2S eval, in numpy: the edit distance behind
the token WER (one pair, or a batch of pairs) and a corpus BLEU accumulator.
The port's own copy of the numpy fallbacks in covomix_tpu/native/__init__.py
(`levenshtein`, `levenshtein_batch`, `BleuScorer`), which give the same
numbers as that package's C++ helpers."""

from __future__ import annotations

import math
from collections import Counter
from typing import Sequence

import numpy as np


def levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    """Edit distance between two token-id sequences. Row by row: with
    base[j] = min(prev[j] + 1, prev[j-1] + (a_i != b_j)) and base[0] = i, the
    row is cur[j] = min_k<=j (base[k] + j - k), one running minimum."""
    aa, bb = np.asarray(a, np.int64), np.asarray(b, np.int64)
    if len(aa) == 0:
        return len(bb)
    ramp = np.arange(len(bb) + 1, dtype=np.int64)
    prev = ramp.copy()
    for i in range(1, len(aa) + 1):
        base = np.empty_like(prev)
        base[0] = i
        base[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (aa[i - 1] != bb))
        prev = np.minimum.accumulate(base - ramp) + ramp
    return int(prev[-1])


def levenshtein_batch(refs: Sequence[Sequence[int]], hyps: Sequence[Sequence[int]]) -> np.ndarray:
    """[N] int64 edit distances of the pairs (refs[i], hyps[i])."""
    assert len(refs) == len(hyps)
    return np.asarray([levenshtein(r, h) for r, h in zip(refs, hyps)], np.int64)


class BleuScorer:
    """Corpus BLEU-4 over token ids: leading pad and trailing pad/eos trimmed,
    unk tokens in the reference never match, clipped 1..4-gram matches
    accumulated across add() calls, brevity penalty."""

    def __init__(self, pad: int, eos: int, unk: int):
        self.pad, self.eos, self.unk = int(pad), int(eos), int(unk)
        # stat = [reflen, predlen, count1, match1, ..., count4, match4]
        self.stat = np.zeros(10, np.int64)

    @staticmethod
    def _trim(seq: np.ndarray, pad: int, eos: int) -> np.ndarray:
        i = 0
        while i < len(seq) and seq[i] == pad:
            i += 1
        j = len(seq)
        while j > i and (seq[j - 1] == pad or seq[j - 1] == eos):
            j -= 1
        return seq[i:j]

    def add(self, ref, pred):
        ref = np.asarray(ref, np.int64).ravel().copy()
        pred = np.asarray(pred, np.int64).ravel()
        ref[ref == self.unk] = -999
        r = self._trim(ref, self.pad, self.eos)
        p = self._trim(pred, self.pad, self.eos)
        self.stat[0] += len(r)
        self.stat[1] += len(p)
        for n in range(1, 5):
            if len(p) < n:
                continue
            pg = [tuple(p[i:i + n]) for i in range(len(p) - n + 1)]
            self.stat[2 * n] += len(pg)
            if len(r) < n:
                continue
            count = Counter(pg)
            for i in range(len(r) - n + 1):
                g = tuple(r[i:i + n])
                if count.get(g, 0) > 0:
                    self.stat[2 * n + 1] += 1
                    count[g] -= 1

    def precision(self):
        return [self.stat[2 * n + 1] / self.stat[2 * n] if self.stat[2 * n] > 0 else 0.0 for n in range(1, 5)]

    def brevity(self) -> float:
        reflen, predlen = int(self.stat[0]), int(self.stat[1])
        if predlen == 0:
            return 0.0
        return min(1.0, math.exp(1 - reflen / predlen))

    def score(self) -> float:
        """BLEU-4 in percent."""
        psum = sum(math.log(p) if p > 0 else float("-inf") for p in self.precision())
        return self.brevity() * math.exp(psum / 4) * 100.0

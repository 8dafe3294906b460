"""Balanced token -> expert assignment (BASE-layer routing; the port's own
numpy copy of `covomix_tpu.native.balanced_assignment`'s numpy auction)."""

from __future__ import annotations

import numpy as np


def balanced_assignment(scores) -> np.ndarray:
    """scores [T, E] with E | T -> expert_of_token [T] int64: every expert
    receives exactly T / E tokens, the total affinity within T eps of the
    optimum (a Gauss-Seidel Bertsekas auction, eps = max(range / 50, 1e-4)).
    Sort tokens by it (stable) for contiguous per-expert chunks."""
    s = np.ascontiguousarray(np.asarray(scores, np.float32))
    assert s.ndim == 2, s.shape
    t, e = s.shape
    assert e > 0 and t % e == 0, f"experts {e} must divide tokens {t}"
    k = t // e
    eps = max((float(s.max()) - float(s.min())) / 50.0, 1e-4)
    cost = np.zeros(t, np.float64)
    owner = np.full(t, -1, np.int64)
    need = np.full(e, k, np.int64)
    queue = list(range(e))
    rounds = 0
    while queue and rounds < 2000 * e:
        rounds += 1
        ex = queue.pop(0)
        m = int(need[ex])
        if m <= 0:
            continue
        value = s[:, ex] - cost
        cand = np.flatnonzero(owner != ex)
        order = cand[np.argsort(-value[cand], kind="stable")]
        take = min(m, len(order))
        runner_up = value[order[take]] if len(order) > take else float(value.min()) - 1.0
        for tk in order[:take]:
            prev = int(owner[tk])
            owner[tk] = ex
            need[ex] -= 1
            cost[tk] += value[tk] - runner_up + eps
            if prev >= 0:
                need[prev] += 1
                queue.append(prev)
        if need[ex] > 0:
            queue.append(ex)
    for ex in range(e):         # experts still short after the round cap take the best free tokens
        while need[ex] > 0:
            free = np.flatnonzero(owner < 0)
            if not len(free):
                break
            owner[free[np.argmax(s[free, ex])]] = ex
            need[ex] -= 1
    return owner

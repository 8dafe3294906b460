"""Small utilities (the port's own copy of covomix_tpu/util/misc.py's helpers)."""

from __future__ import annotations


def round_up(n: int, m: int) -> int:
    """Smallest multiple of m >= n (shared bucketing helper)."""
    return ((n + m - 1) // m) * m

"""Small utilities (the port's own copy of covomix_tpu/util/misc.py's helpers)
and the parameter-tree walk shared by checkpoints and training."""

from __future__ import annotations


def round_up(n: int, m: int) -> int:
    """Smallest multiple of m >= n (shared bucketing helper)."""
    return ((n + m - 1) // m) * m


def named_leaves(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nested dict/list tree in a fixed order; paths are
    '/'-joined keys, the names the `.npz` checkpoints use."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in named_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree, in `named_leaves` order."""
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn, tree):
    """The same nested dict/list structure with `fn` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)

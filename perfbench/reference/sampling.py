"""Judging decoded tokens against reference logits: the token each position
picks, and the widest gap by which a served token's logit lies below the
best one its position allows."""

from __future__ import annotations

import torch


def _kept(values, kept):
    return values if kept is None else values.masked_fill(~kept, float("-inf"))


def best(values, kept=None):
    """The token each position picks: the best value it keeps."""
    return _kept(values, kept).argmax(-1)


def gap(values, kept, tokens, valid=None):
    """Widest gap by which a token's value lies below the best value its
    position keeps (every value where `kept` is None), over the positions
    where `valid`."""
    g = _kept(values, kept).max(-1).values - values.gather(-1, tokens.long().clamp(min=0)[..., None])[..., 0]
    if valid is not None:
        g = torch.where(valid, g, torch.zeros_like(g))
    return float(g.max())

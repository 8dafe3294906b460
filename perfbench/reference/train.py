"""Reference training steps: the flow-matching loss (OT-CFM, Voicebox eq.
5-6) and Adam, plain autograd in float32.

OT-CFM on a batch {x, phonemes, mask}: the target mel x1 (VoMix two_one: the
last 80 channels, the condition the first 160; otherwise both are x), noise
x0 and a time t per row: w = (1 - t) x0 + t x1, flow = x1 - x0, the
condition zeroed on the masked frames, the null condition on the dropped
rows; the loss is the masked-frame mean of the squared error of the field
against the flow, averaged over the rows. Adam: beta 0.9 / 0.999, eps
1e-8, bias-corrected, no weight decay."""

from __future__ import annotations

import torch

from perfbench.reference import acoustic as RA
from perfbench.reference import nn
from perfbench.reference import t2s as RT
from perfbench.reference.nn import F32, Precision


def cfm_draws(gen: torch.Generator, batch: int, frames: int, mel_dim: int, cond_drop_prob: float):
    """(x0, times, drop) of one step, drawn from `gen` on its device in the
    order the objective takes them: x0 ~ N(0, I) [B, T, mel_dim],
    t ~ U[0, 1) [B], drop = U[0, 1) [B] < cond_drop_prob."""
    dev = gen.device
    x0 = torch.randn((batch, frames, mel_dim), generator=gen, device=dev)
    times = torch.rand((batch,), generator=gen, device=dev)
    drop = torch.rand((batch,), generator=gen, device=dev) < cond_drop_prob
    return x0, times, drop


def cfm_loss(params, c: dict, batch: dict, draws, q: Precision = F32):
    x0, times, drop = draws
    x, mask = batch["x"].float(), batch["mask"]
    target, cond = (x[..., -80:], x[..., :-80]) if c["mode"] == "two_one" else (x, x)
    t = times[:, None, None]
    w = (1 - t) * x0 + t * target
    flow = target - x0
    cond = cond * (~mask)[..., None]
    full = torch.full((x.shape[0],), x.shape[1], device=x.device)
    pred = RA.field(params, c, w, batch["phonemes"], cond, times, drop, full, q)
    err = torch.where(mask, torch.mean(torch.square(pred - flow), dim=-1), torch.zeros((), device=x.device))
    return torch.sum(err.sum(-1) / mask.sum(-1).float().clamp(min=1e-5)) / x.shape[0]


def t2s_loss(params, c: dict, batch: dict, draws=None, q: Precision = F32):
    return RT.loss(params, c, batch["text_ids"], batch["semantic_ids"], q)


def tree_like(leaves, like):
    """`leaves` (in `leaves_of` order) in the nesting of the tree `like`."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [fill(v) for v in t]
        return next(it)
    return fill(like)


def names_of(tree, prefix: str = "") -> list:
    """The leaves' '/'-joined paths, in `leaves_of` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in names_of(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in names_of(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def leaves_of(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_of(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves_of(v)]
    return [tree]


def adam_steps(params, loss_fn, batches, draws, lr: float, q: Precision = F32,
               betas=(0.9, 0.999), eps: float = 1e-8):
    """len(batches) Adam steps of loss_fn(params, c-bound, batch, draws) from
    `params`; returns (losses [K], first moments, parameters after), the
    last two as lists in the tree's leaf order."""
    p = [t.detach().float().clone().requires_grad_(True) for t in leaves_of(params)]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    losses = []
    with nn.strict_f32():
        for k, (batch, draw) in enumerate(zip(batches, draws), start=1):
            loss = loss_fn(tree_like(p, params), batch, draw, q)
            grads = torch.autograd.grad(loss, p, allow_unused=True)
            losses.append(float(loss.detach()))
            with torch.no_grad():
                for t, g, mk, vk in zip(p, grads, m, v):
                    g = torch.zeros_like(t) if g is None else g
                    mk.mul_(betas[0]).add_(g, alpha=1 - betas[0])
                    vk.mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                    step = (mk / (1 - betas[0] ** k)) / ((vk / (1 - betas[1] ** k)).sqrt() + eps)
                    t.sub_(lr * step)
            del grads, loss
    return losses, m, [t.detach() for t in p]

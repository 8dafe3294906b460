"""Token sampling ops (port of covomix_tpu/ops/sampling.py). Randomness comes
from an explicit `torch.Generator`."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def safe_log(t, eps: float = 1e-20):
    return torch.log(torch.clamp(t, min=eps))


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """-log(-log(U)), U ~ uniform[0, 1) drawn from `generator`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -safe_log(-safe_log(u))


def gumbel_sample(generator: torch.Generator, logits, temperature: float = 1.0, dim: int = -1, rows=None):
    """argmax(logits / max(T, 1e-10) + gumbel). `rows` = (total, slice):
    the logits are those rows of a batch of `total` (a dp rank's share),
    whose noise is drawn whole and sliced, so each row's noise is the whole
    batch's."""
    t = max(float(temperature), 1e-10)
    if rows is None:
        noise = gumbel_noise(generator, logits.shape, logits.device)
    else:
        noise = gumbel_noise(generator, (rows[0], *logits.shape[1:]), logits.device)[rows[1]]
    return torch.argmax(logits / t + noise, dim=dim)


def top_k_filter(logits, thres: float = 0.1, k: int | None = None):
    """Keep the top-k logits (ties with the k-th kept: `logits < kth` is
    what is dropped), set the rest to NEG_INF. Default k = ceil(thres * V)."""
    vocab = logits.shape[-1]
    if k is None:
        k = math.ceil(thres * vocab)
    k = max(1, min(k, vocab))
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def top_p_filter(logits, thres: float = 0.9):
    """Nucleus filter: over the logits sorted in descending order, drop every
    token after the sorted cumulative softmax first exceeds `thres` (the
    token that crosses is kept); dropped logits become NEG_INF."""
    sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, dims=(-1,))
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = torch.cat([torch.zeros_like(cum[..., :1], dtype=torch.bool), (cum > thres)[..., :-1]], dim=-1)
    cutoff = torch.amin(sorted_logits.masked_fill(remove, float("inf")), dim=-1, keepdim=True)
    return torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)


def mask_after_eos(tokens, eos_id: int, pad_id: int):
    """Replace everything strictly after the first EOS with pad_id."""
    after = torch.cumsum((tokens == eos_id).int(), dim=-1) > 0
    after = torch.cat([torch.zeros_like(after[..., :1]), after[..., :-1]], dim=-1)
    return torch.where(after, torch.full_like(tokens, pad_id), tokens)


def ban_repeated_ngrams(logits, tokens, cur_len, n: int):
    """No-repeat-ngram masking: for every earlier window equal to the last
    n-1 generated tokens, ban the token that followed it. `tokens` [B, L] is
    the decode buffer, `cur_len` the number of tokens generated so far (an
    int or a 0-dim tensor on the tokens' device). Fixed shapes and no host
    read, so a captured decode step can run it: the bans are a scatter-add
    of masked ones. No-op while cur_len < n."""
    if n <= 0:
        return logits
    b, l = tokens.shape
    cur = torch.as_tensor(cur_len, device=tokens.device)
    start = torch.clamp(cur - (n - 1), min=0)
    prefix = tokens.index_select(1, (start + torch.arange(n - 1, device=tokens.device)) % l)
    eq = torch.ones((b, l), dtype=torch.bool, device=tokens.device)
    for i in range(n - 1):
        eq &= torch.roll(tokens, -i, dims=1) == prefix[:, i][:, None]
    pos = torch.arange(l, device=tokens.device)[None, :]
    banned = torch.roll(tokens, -(n - 1), dims=1)                  # tokens[j+n-1] at column j
    ok = eq & (pos + n - 1 < cur) & (cur >= n) & (banned >= 0) & (banned < logits.shape[-1])
    counts = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    counts.scatter_add_(1, torch.where(ok, banned, 0).long(), ok.to(torch.int32))
    return torch.where(counts > 0, torch.full_like(logits, NEG_INF), logits)


def set_eos_id(tokens, eos_id: int, pad_id: int):
    """Append one position and write eos at the first pad slot per row."""
    lengths = torch.sum(torch.cumsum((tokens == pad_id).int(), dim=-1) == 0, dim=-1)
    out = torch.nn.functional.pad(tokens, (0, 1), value=pad_id)
    pos = torch.arange(out.shape[-1], device=tokens.device)
    return torch.where(pos[None, :] == lengths[:, None], torch.full_like(out, eos_id), out)

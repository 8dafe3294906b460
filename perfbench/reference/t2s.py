"""Reference text-to-semantic transformer (CoSingle / CoMix), teacher forced.

Encoder: text embedding of [ids ‖ EOS], `source_depth` pre-norm layers
(RMSNorm, self-attention with interleaved rotary, RMSNorm, GEGLU), final
RMSNorm. Decoder over [start ‖ tokens[:-1]] (two streams: the two tokens'
embeddings side by side): causal self-attention with interleaved rotary,
cross-attention over a learned null key/value slot and the encoder output
(keys and values projected from it without a norm), GEGLU, final RMSNorm.
Logits are tied to the semantic embedding, per stream on its half of the
hidden state; position i scores token i. The training loss is the
cross-entropy of every target and the final EOS, summed over the streams."""

from __future__ import annotations

import torch

from perfbench.reference import nn
from perfbench.reference.nn import F32, Precision


def _geglu_ff(p, x, q):
    h = nn.linear(p["w1"], nn.rmsnorm(p["norm"]["gamma"], x), q)
    a, gate = torch.chunk(h, 2, dim=-1)
    return nn.linear(p["w2"], nn.gelu(gate) * a, q)


def _self_attention(p, x, heads, causal, q):
    h = nn.rmsnorm(p["norm"]["gamma"], x)
    qh = nn.split_heads(nn.linear(p["q"], h, q), heads)
    k, v = torch.chunk(nn.linear(p["kv"], h, q), 2, dim=-1)
    k, v = nn.split_heads(k, heads), nn.split_heads(v, heads)
    pos = torch.arange(x.shape[1], device=x.device)
    out = nn.attention(nn.rotary_interleaved(qh, pos), nn.rotary_interleaved(k, pos), v, causal=causal, prec=q)
    return nn.linear(p["out"], nn.merge_heads(out), q)


def _cross_attention(p, x, context, heads, q):
    h = nn.rmsnorm(p["norm"]["gamma"], x)
    qh = nn.split_heads(nn.linear(p["q"], h, q), heads)
    k, v = torch.chunk(nn.linear(p["kv"], context, q), 2, dim=-1)
    k, v = nn.split_heads(k, heads), nn.split_heads(v, heads)
    b = x.shape[0]
    nk = p["null_kv"][0].float()[None].expand(b, -1, -1, -1)
    nv = p["null_kv"][1].float()[None].expand(b, -1, -1, -1)
    out = nn.attention(qh, torch.cat([nk, k], dim=2), torch.cat([nv, v], dim=2), prec=q)
    return nn.linear(p["out"], nn.merge_heads(out), q)


def encode(params, c: dict, text_ids: torch.Tensor, q: Precision = F32):
    """text_ids [B, S] (no padding, no EOS) -> encoder output [B, S + 1, dim]."""
    eos = torch.full((text_ids.shape[0], 1), c["num_text_tokens"], device=text_ids.device)
    ids = torch.cat([text_ids.long().clamp(0, c["num_text_tokens"]), eos], dim=1)
    x = params["text_emb"]["w"].float()[ids]
    for lp in params["source_layers"]:
        x = x + _self_attention(lp["self_attn"], x, c["heads"], False, q)
        x = x + _geglu_ff(lp["ff"], x, q)
    return nn.rmsnorm(params["source_final_norm"]["gamma"], x)


def decode(params, c: dict, context, tokens1, tokens2=None, q: Precision = F32):
    """Teacher-forced logits of n positions from the tokens [B, n] (position
    i reads tokens[:i] and scores token i): ([B, n, V + 1], same or None)."""
    emb = params["sem_emb"]["w"].float()
    v = c["num_semantic_tokens"]
    x = emb[tokens1[:, :-1].long().clamp(0, v)]
    if c["two_output"]:
        x = torch.cat([x, emb[tokens2[:, :-1].long().clamp(0, v)]], dim=-1)
    start = params["start_speech"].float()[None, None, :].expand(x.shape[0], 1, -1)
    x = torch.cat([start, x], dim=1)
    for lp in params["target_layers"]:
        x = x + _self_attention(lp["self_attn"], x, c["heads"], True, q)
        x = x + _cross_attention(lp["cross_attn"], x, context, c["heads"], q)
        x = x + _geglu_ff(lp["ff"], x, q)
    x = nn.rmsnorm(params["target_final_norm"]["gamma"], x)
    if not c["two_output"]:
        return q(x) @ q(emb).T, None
    half = c["target_dim"] // 2
    return q(x[..., :half]) @ q(emb).T, q(x[..., half:]) @ q(emb).T


@torch.no_grad()
def logits(params, c: dict, text_ids: torch.Tensor, tokens1: torch.Tensor, tokens2=None, q: Precision = F32):
    """Requests' teacher-forced logits over their n decoded tokens: text_ids
    [B, S], tokens [B, n] -> ([B, n, V + 1] of stream 1, the same of stream
    2 or None)."""
    with nn.strict_f32():
        return decode(params, c, encode(params, c, text_ids, q), tokens1, tokens2, q)


def loss(params, c: dict, text_ids, targets, q: Precision = F32):
    """The training cross-entropy: text_ids [B, S], targets [B, T] (two
    streams: [B, T, 2]) without padding; each stream's targets and EOS,
    the mean over positions, summed over the streams."""
    eos = torch.full((targets.shape[0], 1), c["num_semantic_tokens"], device=targets.device)
    streams = [targets[..., i] for i in range(2)] if c["two_output"] else [targets]
    full = [torch.cat([t.long(), eos], dim=1) for t in streams]
    context = encode(params, c, text_ids, q)
    lgs = decode(params, c, context, full[0], full[1] if c["two_output"] else None, q)
    total = 0.0
    for lg, tgt in zip(lgs, full):
        total = total + torch.nn.functional.cross_entropy(lg.reshape(-1, lg.shape[-1]), tgt.reshape(-1))
    return total

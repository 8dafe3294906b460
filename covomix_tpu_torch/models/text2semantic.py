"""Text -> semantic-token transformer (CoSingle / CoMix): port of
covomix_tpu/models/text2semantic.py.

  * non-causal source (text) encoder with interleaved rotary
  * causal target decoder with cross-attention (+ learned null-KV slot),
    GEGLU feed-forward, weight-tied token embedding / logit projection
  * training forward with teacher forcing and the CE (`forward_loss`), the
    two-stream CE sum for CoMix
  * autoregressive decode with per-layer KV caches, top-k + Gumbel sampling,
    EOS stop, mask-after-EOS cleanup; CoMix two-stream decode (`two_output`)
    splits the decoder hidden in half, one logit head per stream.

In training the batches are right-padded, so the key masks are prefix masks:
`forward_loss` hands them on as per-row lengths, and the full-sequence
self-attention goes through `attend_flash_or_xla`, which takes the flash
kernels (the decoder's causal form) on CUDA from 512 positions on and
`layers.attend` otherwise. `generate` is a Python loop that stops as soon as
the JAX package's while_loop condition would; it attends through
`layers.attend` (the JAX package's decode path uses no kernel either)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.models.acoustic import linear_init
from covomix_tpu_torch.ops import sampling as S
from covomix_tpu_torch.ops.flash_attention import attend_flash_or_xla

_SPECULATIVE_ITEM = "ROADMAP.md 'Modules to port': speculative decode"


@dataclasses.dataclass(frozen=True)
class T2SConfig:
    dim: int = 512                    # encoder width
    source_depth: int = 4
    target_depth: int = 4
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    num_text_tokens: int = 30528      # text vocab (without the auto EOS row)
    num_semantic_tokens: int = 501    # semantic vocab (without the auto EOS row)
    target_dim: int = 512             # decoder width (1024 for CoMix)
    two_output: bool = False          # CoMix dual-stream decode
    two_input: bool = False           # dual text streams
    no_source_transformer: bool = False
    text_pad_id: int = 0
    semantic_pad_id: int = -1
    cond_drop_prob: float = 0.0
    classifier_free_guidance: bool = False
    target_early_exit_layer: int = 0   # 0 = no early-exit head (speculative decoding)
    detach_early_exit_embed: bool = False

    @property
    def text_eos_id(self) -> int:
        return self.num_text_tokens

    @property
    def semantic_eos_id(self) -> int:
        return self.num_semantic_tokens

    @property
    def text_emb_dim(self) -> int:
        return self.dim // 2 if self.two_input else self.dim

    @property
    def sem_emb_dim(self) -> int:
        return self.target_dim // 2 if self.two_output else self.target_dim

    @property
    def ff_inner(self) -> int:
        # GEGLU inner dim = int(dim * mult * 2/3)
        return int(self.dim * self.ff_mult * 2 / 3)

    @property
    def target_ff_inner(self) -> int:
        return int(self.target_dim * self.ff_mult * 2 / 3)


# ---------------------------------------------------------------------------
# init (same names and shapes as the JAX package; numbers from a Generator)


def _attn_init(gen, dim, heads, dim_head, *, dim_context=None, null_kv=False, device=None):
    dim_context = dim_context or dim
    p = {
        "norm": {"gamma": torch.ones(dim, device=device)},
        "q": linear_init(gen, dim, heads * dim_head, bias=False, device=device),
        "kv": linear_init(gen, dim_context, heads * dim_head * 2, bias=False, device=device),
        "out": linear_init(gen, heads * dim_head, dim, bias=False, device=device),
    }
    if null_kv:
        p["null_kv"] = torch.randn(2, heads, 1, dim_head, generator=gen, device=device)
    return p


def _ff_init(gen, dim, inner, device=None):
    return {"norm": {"gamma": torch.ones(dim, device=device)},
            "w1": linear_init(gen, dim, inner * 2, device=device),
            "w2": linear_init(gen, inner, dim, device=device)}


def init(gen: torch.Generator, cfg: T2SConfig, device=None):
    """Random parameters drawn from `gen`. The early-exit draft head is not
    created: speculative decode is not ported yet."""
    device = device or gen.device
    rn = lambda *s: torch.randn(s, generator=gen, device=device)
    p = {
        "text_emb": {"w": rn(cfg.num_text_tokens + 1, cfg.text_emb_dim)},
        "sem_emb": {"w": rn(cfg.num_semantic_tokens + 1, cfg.sem_emb_dim)},
        "start_text": rn(cfg.dim),
        "start_speech": rn(cfg.target_dim),
        "source_final_norm": {"gamma": torch.ones(cfg.dim, device=device)},
        "target_final_norm": {"gamma": torch.ones(cfg.target_dim, device=device)},
    }
    if cfg.classifier_free_guidance:
        p["null_source_embedding"] = torch.zeros(cfg.dim, device=device)
    if not cfg.no_source_transformer:
        p["source_layers"] = [
            {"self_attn": _attn_init(gen, cfg.dim, cfg.heads, cfg.dim_head, device=device),
             "ff": _ff_init(gen, cfg.dim, cfg.ff_inner, device=device)}
            for _ in range(cfg.source_depth)]
    p["target_layers"] = [
        {"self_attn": _attn_init(gen, cfg.target_dim, cfg.heads, cfg.dim_head, device=device),
         "cross_attn": _attn_init(gen, cfg.target_dim, cfg.heads, cfg.dim_head, dim_context=cfg.dim,
                                  null_kv=True, device=device),
         "ff": _ff_init(gen, cfg.target_dim, cfg.target_ff_inner, device=device)}
        for _ in range(cfg.target_depth)]
    return p


# ---------------------------------------------------------------------------
# blocks


def _ff(p, x):
    h = L.linear(p["w1"], L.rmsnorm(p["norm"], x))
    return L.linear(p["w2"], L.geglu(h))


def _self_attn_full(p, x, heads, *, mask=None, causal=False, rotary=True, prefix_lens=None):
    """Full-sequence self-attention (training, encoder). With `prefix_lens`
    ([B] int, the per-row valid lengths of a right-padded batch) and no
    `mask`, it goes through `attend_flash_or_xla` (the flash kernels on CUDA
    from 512 positions on, also causal); a bool key `mask` [B, T] keeps
    `layers.attend`."""
    h = L.rmsnorm(p["norm"], x)
    q = L.split_heads(L.linear(p["q"], h), heads)
    k, v = torch.chunk(L.linear(p["kv"], h), 2, dim=-1)
    k, v = L.split_heads(k, heads), L.split_heads(v, heads)
    if rotary:
        inv = L.rotary_freqs(q.shape[-1], device=x.device)
        pos = torch.arange(x.shape[1], device=x.device)
        q, k = L.rotary_interleaved(pos, inv, q), L.rotary_interleaved(pos, inv, k)
    if prefix_lens is not None and mask is None:
        out = attend_flash_or_xla(q, k, v, valid_len=prefix_lens, causal=causal)
    else:
        out = L.attend(q, k, v, key_mask=mask, causal=causal)
    return L.linear(p["out"], L.merge_heads(out))


def _cross_attn(p, x, context_kv, heads, *, context_mask=None):
    """Cross-attention with the learned null-KV slot prepended. context_kv:
    precomputed (k, v) [B, H, S, dh] without the null slot."""
    h = L.rmsnorm(p["norm"], x)
    q = L.split_heads(L.linear(p["q"], h), heads)
    k, v = context_kv
    b = x.shape[0]
    nk = p["null_kv"][0].to(k.dtype).expand((b,) + tuple(p["null_kv"][0].shape))
    nv = p["null_kv"][1].to(v.dtype).expand((b,) + tuple(p["null_kv"][1].shape))
    k = torch.cat([nk, k], dim=-2)
    v = torch.cat([nv, v], dim=-2)
    if context_mask is not None:
        context_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=x.device), context_mask], dim=-1)
    out = L.attend(q, k, v, key_mask=context_mask)
    return L.linear(p["out"], L.merge_heads(out))


def _context_kv(p_cross, context, heads):
    k, v = torch.chunk(L.linear(p_cross["kv"], context), 2, dim=-1)
    return L.split_heads(k, heads), L.split_heads(v, heads)


def encode_source(params, cfg: T2SConfig, source_emb, source_mask, dtype=torch.float32, prefix_lens=None):
    """Source transformer (non-causal, rotary) + final RMSNorm. `prefix_lens`:
    the per-row lengths of a right-padded batch in place of `source_mask`
    (see _self_attn_full)."""
    x = source_emb.to(dtype)
    if cfg.no_source_transformer:
        return x
    mask = None if prefix_lens is not None else source_mask
    for lp in params["source_layers"]:
        x = _self_attn_full(lp["self_attn"], x, cfg.heads, mask=mask, prefix_lens=prefix_lens) + x
        x = _ff(lp["ff"], x) + x
    return L.rmsnorm(params["source_final_norm"], x)


def embed_source(params, cfg: T2SConfig, source_ids, dtype=torch.float32):
    """Token ids -> embeddings; two_input concatenates both streams."""
    ids = torch.clamp(source_ids, 0, cfg.num_text_tokens)
    if cfg.two_input:
        e1 = L.embedding(params["text_emb"], ids[..., 0], dtype)
        e2 = L.embedding(params["text_emb"], ids[..., 1], dtype)
        return torch.cat([e1, e2], dim=-1)
    return L.embedding(params["text_emb"], ids, dtype)


def _embed_target(params, cfg: T2SConfig, t1, t2, dtype):
    e = L.embedding(params["sem_emb"], torch.clamp(t1, 0, cfg.num_semantic_tokens), dtype)
    if cfg.two_output:
        e2 = L.embedding(params["sem_emb"], torch.clamp(t2, 0, cfg.num_semantic_tokens), dtype)
        e = torch.cat([e, e2], dim=-1)
    return e


def _sem_logits(params, h, dtype):
    """Weight-tied logits h @ emb^T (includes the EOS row), in f32."""
    return (h @ params["sem_emb"]["w"].to(dtype).T).float()


# ---------------------------------------------------------------------------
# training forward


def forward_loss(params, cfg: T2SConfig, source_ids, target_ids, *, generator: Optional[torch.Generator] = None,
                 source_mask=None, source_emb=None, cond_drop: bool = False, dtype=torch.float32,
                 return_logits: bool = False):
    """Teacher-forced CE. source_ids [B, S] (two_input: [B, S, 2]), or None
    with precomputed `source_emb` [B, S, dim] and its `source_mask`;
    target_ids [B, T] (two_output: [B, T, 2]) padded with the collate pad 501.
    semantic_pad_id -1 means every position counts in the CE. The decoder
    reads [BOS | targets with EOS]; logits[:, i] predicts target i, and the
    two-stream loss is the sum of both streams' CE. `cond_drop` with
    `classifier_free_guidance` replaces a row's context by the null source
    embedding with probability cond_drop_prob, drawn from `generator`.
    Returns the loss (0-dim f32), or (loss, logits) with `return_logits`
    (two_output: a pair of logits)."""
    if cfg.target_early_exit_layer > 0:
        raise NotImplementedError(f"the early-exit CE of speculative decoding is not ported yet "
                                  f"({_SPECULATIVE_ITEM})")
    # only masks derived here from right-padded ids are provably prefix masks
    mask_is_prefix = source_mask is None and source_emb is None
    if source_emb is not None:
        if source_mask is None:
            raise ValueError("precomputed source_emb requires source_mask")
        source_ids = None
    elif cfg.two_input:
        s1 = S.set_eos_id(source_ids[..., 0], cfg.text_eos_id, cfg.text_pad_id)
        s2 = S.set_eos_id(source_ids[..., 1], cfg.text_eos_id, cfg.text_pad_id)
        source_ids = torch.stack([s1, s2], dim=-1)
        if source_mask is None:
            source_mask = s1 != cfg.text_pad_id
    else:
        source_ids = S.set_eos_id(source_ids, cfg.text_eos_id, cfg.text_pad_id)
        if source_mask is None:
            source_mask = source_ids != cfg.text_pad_id

    if cfg.two_output:
        t1 = S.set_eos_id(target_ids[..., 0], cfg.semantic_eos_id, cfg.semantic_pad_id)
        t2 = S.set_eos_id(target_ids[..., 1], cfg.semantic_eos_id, cfg.semantic_pad_id)
    else:
        t1 = S.set_eos_id(target_ids if target_ids.dim() == 2 else target_ids[..., 0], cfg.semantic_eos_id,
                          cfg.semantic_pad_id)
        t2 = t1

    # right-padded batches: the pad masks are prefix masks, handed on as
    # per-row lengths (the decoder's causal self-attention then takes the
    # flash kernels); +1 for the BOS row
    dec_lens = 1 + torch.sum(t1 != cfg.semantic_pad_id, dim=-1, dtype=torch.int32)
    src_lens = torch.sum(source_mask, dim=-1, dtype=torch.int32) if mask_is_prefix else None

    if source_emb is None:
        source_emb = embed_source(params, cfg, source_ids, dtype)
    context = encode_source(params, cfg, source_emb, source_mask, dtype, prefix_lens=src_lens)

    if cfg.classifier_free_guidance and cond_drop and generator is not None:
        drop = torch.rand(context.shape[0], generator=generator, device=generator.device).to(context.device)
        drop = drop < cfg.cond_drop_prob
        null = params["null_source_embedding"].to(dtype)[None, None, :]
        context = torch.where(drop[:, None, None], null, context)

    b = t1.shape[0]
    start = params["start_speech"].to(dtype)[None, None, :].expand(b, 1, cfg.target_dim)
    x = torch.cat([start, _embed_target(params, cfg, t1, t2, dtype)], dim=1)
    for lp in params["target_layers"]:
        x = _self_attn_full(lp["self_attn"], x, cfg.heads, causal=True, prefix_lens=dec_lens) + x
        ckv = _context_kv(lp["cross_attn"], context, cfg.heads)
        x = _cross_attn(lp["cross_attn"], x, ckv, cfg.heads, context_mask=source_mask) + x
        x = _ff(lp["ff"], x) + x
    x = L.rmsnorm(params["target_final_norm"], x)

    def ce(logits, tgt):
        logits = logits[:, :-1]     # the last position predicts past the end
        valid = tgt != cfg.semantic_pad_id
        tgt_c = torch.clamp(tgt, 0, cfg.num_semantic_tokens).long()
        nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, tgt_c[..., None])[..., 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)

    if cfg.two_output:
        half = cfg.target_dim // 2
        logits = (_sem_logits(params, x[..., :half], dtype), _sem_logits(params, x[..., half:], dtype))
        loss = ce(logits[0], t1) + ce(logits[1], t2)
    else:
        logits = _sem_logits(params, x, dtype)
        loss = ce(logits, t1)
    if return_logits:
        return loss, logits
    return loss


# ---------------------------------------------------------------------------
# autoregressive decode


class GenerateResult(NamedTuple):
    tokens: torch.Tensor       # [B, L] stream-1 tokens, pad-filled after EOS
    tokens2: torch.Tensor      # [B, L] stream-2 (== tokens when not two_output)
    lengths: torch.Tensor      # [B] decoded positions (incl. EOS)
    lengths2: torch.Tensor
    num_steps: int             # decode iterations executed


@torch.no_grad()
def generate(params, cfg: T2SConfig, generator: Optional[torch.Generator], source_ids, *,
             max_length: int = 2048, temperature: float = 1.0, top_k_thres: float = 0.1,
             cond_scale: float = 1.0, min_length: int = 0, no_repeat_ngram_size: int = 0,
             source_emb=None, source_mask=None, dtype=torch.float32,
             speculative: bool = False) -> GenerateResult:
    """Top-k + Gumbel AR decode of up to max_length steps. Stops when every
    row has emitted EOS (two_output: when either stream has). After a stop,
    positions after EOS become pad; positions never written are pad either way.
    `min_length` masks the EOS logit for the first min_length steps."""
    if speculative:
        raise NotImplementedError(f"speculative decode is not ported yet ({_SPECULATIVE_ITEM})")
    b = (source_ids if source_emb is None else source_emb).shape[0]
    heads, dh = cfg.heads, cfg.dim_head
    eos, pad = cfg.semantic_eos_id, cfg.semantic_pad_id

    if source_emb is not None:
        if source_mask is None:
            raise ValueError("precomputed source_emb requires source_mask")
        dev = source_emb.device
    else:
        dev = source_ids.device
        if cfg.two_input:
            s1 = S.set_eos_id(source_ids[..., 0], cfg.text_eos_id, cfg.text_pad_id)
            s2 = S.set_eos_id(source_ids[..., 1], cfg.text_eos_id, cfg.text_pad_id)
            source_ids = torch.stack([s1, s2], dim=-1)
            src_flat = s1
        else:
            source_ids = S.set_eos_id(source_ids, cfg.text_eos_id, cfg.text_pad_id)
            src_flat = source_ids
        source_mask = src_flat != cfg.text_pad_id
        source_emb = embed_source(params, cfg, source_ids, dtype)
    context = encode_source(params, cfg, source_emb, source_mask, dtype)

    use_cfg = cond_scale > 1.0
    if use_cfg:  # null-context branch folded into the batch
        context = torch.cat([context, context], dim=0)
        source_mask_all = torch.cat([source_mask, torch.zeros_like(source_mask)], dim=0)
        bb = 2 * b
    else:
        source_mask_all = source_mask
        bb = b
    cross_kvs = [_context_kv(lp["cross_attn"], context, heads) for lp in params["target_layers"]]
    inv = L.rotary_freqs(dh, device=dev)
    cache_k = [torch.zeros((bb, heads, max_length, dh), dtype=dtype, device=dev) for _ in params["target_layers"]]
    cache_v = [torch.zeros((bb, heads, max_length, dh), dtype=dtype, device=dev) for _ in params["target_layers"]]
    tokens1 = torch.full((b, max_length), pad, dtype=torch.int32, device=dev)
    tokens2 = torch.full((b, max_length), pad, dtype=torch.int32, device=dev)
    done1 = torch.zeros(b, dtype=torch.bool, device=dev)
    done2 = torch.zeros(b, dtype=torch.bool, device=dev)
    start = params["start_speech"].to(dtype)[None, :].expand(b, -1)
    eos_col = torch.arange(cfg.num_semantic_tokens + 1, device=dev) == eos

    def decode_step(i, prev1, prev2):
        """Decoder forward for position i (writes the caches); [bb, tdim]."""
        x = start if i == 0 else _embed_target(params, cfg, prev1, prev2, dtype)
        if use_cfg:
            x = torch.cat([x, x], dim=0)
        x = x[:, None, :]
        pos = torch.full((1,), i, device=dev)
        for li, lp in enumerate(params["target_layers"]):
            sa = lp["self_attn"]
            h = L.rmsnorm(sa["norm"], x)
            q = L.split_heads(L.linear(sa["q"], h), heads)
            k_new, v_new = torch.chunk(L.linear(sa["kv"], h), 2, dim=-1)
            k_new, v_new = L.split_heads(k_new, heads), L.split_heads(v_new, heads)
            q = L.rotary_interleaved(pos, inv, q)
            cache_k[li][:, :, i] = L.rotary_interleaved(pos, inv, k_new)[:, :, 0]
            cache_v[li][:, :, i] = v_new[:, :, 0]
            # keys past i are masked in the JAX decode; here they are not read
            att = L.attend(q, cache_k[li][:, :, : i + 1], cache_v[li][:, :, : i + 1])
            x = L.linear(sa["out"], L.merge_heads(att)) + x
            x = _cross_attn(lp["cross_attn"], x, cross_kvs[li], heads, context_mask=source_mask_all) + x
            x = _ff(lp["ff"], x) + x
        return L.rmsnorm(params["target_final_norm"], x)[:, 0]

    def head_logits(h):
        if cfg.two_output:
            half = cfg.target_dim // 2
            return _sem_logits(params, h[..., :half], dtype), _sem_logits(params, h[..., half:], dtype)
        lg = _sem_logits(params, h, dtype)
        return lg, lg

    i = 0
    stopped = False
    while i < max_length:
        prev1 = tokens1[:, max(i - 1, 0)]
        prev2 = tokens2[:, max(i - 1, 0)]
        lg1, lg2 = head_logits(decode_step(i, prev1, prev2))
        if use_cfg:
            lg1 = lg1[b:] + (lg1[:b] - lg1[b:]) * cond_scale
            lg2 = lg2[b:] + (lg2[:b] - lg2[b:]) * cond_scale
        if i < min_length:
            lg1 = lg1.masked_fill(eos_col[None, :], S.NEG_INF)
            lg2 = lg2.masked_fill(eos_col[None, :], S.NEG_INF)
        if no_repeat_ngram_size > 0:
            lg1 = S.ban_repeated_ngrams(lg1, tokens1, i, no_repeat_ngram_size)
            if cfg.two_output:
                lg2 = S.ban_repeated_ngrams(lg2, tokens2, i, no_repeat_ngram_size)
        s1 = S.gumbel_sample(generator, S.top_k_filter(lg1, thres=top_k_thres), temperature).to(torch.int32)
        tokens1[:, i] = s1
        done1 = done1 | (s1 == eos)
        if cfg.two_output:
            s2 = S.gumbel_sample(generator, S.top_k_filter(lg2, thres=top_k_thres), temperature).to(torch.int32)
            tokens2[:, i] = s2
            done2 = done2 | (s2 == eos)
        else:
            tokens2 = tokens1
            done2 = done1
        i += 1
        stopped = bool(done1.all()) or (cfg.two_output and bool(done2.all()))
        if stopped:
            break

    if stopped:  # the reference masks after EOS only when the loop broke
        tokens1 = S.mask_after_eos(tokens1, eos, pad)
        tokens2 = S.mask_after_eos(tokens2, eos, pad)
    len1 = torch.sum(tokens1 != pad, dim=-1)
    len2 = torch.sum(tokens2 != pad, dim=-1)
    return GenerateResult(tokens1, tokens2, len1, len2, i)

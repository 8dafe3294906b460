"""Text -> semantic-token transformer (CoSingle / CoMix): port of
covomix_tpu/models/text2semantic.py.

  * non-causal source (text) encoder with interleaved rotary
  * causal target decoder with cross-attention (+ learned null-KV slot),
    GEGLU feed-forward, weight-tied token embedding / logit projection
  * training forward with teacher forcing and the CE (`forward_loss`), the
    two-stream CE sum for CoMix
  * the early-exit draft head (`early_exit`: residual GEGLU feed-forward ->
    RMSNorm -> logits, a second head for CoMix's stream 2) and its CE
  * autoregressive decode with per-layer KV caches, top-k + Gumbel sampling,
    EOS stop, mask-after-EOS cleanup; CoMix two-stream decode (`two_output`)
    splits the decoder hidden in half, one logit head per stream
  * greedy self-speculative decode (`generate_speculative`): the early-exit
    head drafts, one full-depth forward verifies; the tokens of greedy
    `generate`
  * the auxiliary losses `semantic_to_text_loss` (back-translation) and
    `speech_speech_pretrain_loss` (denoising pretraining).

In training the batches are right-padded, so the key masks are prefix masks:
`forward_loss` hands them on as per-row lengths, and the full-sequence
self-attention goes through `attend_flash_or_xla`, which takes the flash
kernels (the decoder's causal form) on CUDA from 512 positions on and
`layers.attend` otherwise. `generate` and `generate_speculative` are, like
the JAX package's while_loops, one step function over preallocated caches
(attention over the whole cache under a position mask), run as a CUDA graph
on the card and directly on the CPU, with one read of a device flag per
chunk of steps; they attend through `layers.attend` / einsum (the JAX
package's decode paths use no kernel either).

`forward_loss` with a mesh whose tp axis has collectives reads this rank's
tp shards (parallel/mesh.py `shard_params`) and runs tensor-parallel
(parallel/tensor.py): each attention on the rank's heads (its q columns,
its heads' k and v columns of `kv`, its rows of `out`, its heads' slice of
the replicated `null_kv`), each GEGLU feed-forward on its (value, gate)
pairs of `w1` and rows of `w2` where tp divides the pairs, and else with
`w1` gathered; the vocab-split `sem_emb` gathered for the token lookup and
its weight-tied logits computed on the rank's rows and gathered before
the loss, so every tp rank computes the same loss. Decoding stays
unsharded, as in JAX."""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.models.layers import embedding_init, linear_init, rmsnorm_init
from covomix_tpu_torch.ops import sampling as S
from covomix_tpu_torch.ops.flash_attention import attend_flash_or_xla
from covomix_tpu_torch.parallel import tensor as TPX
from covomix_tpu_torch.util import profiling
from covomix_tpu_torch.util.misc import tree_leaves, tree_map

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
        "norm": rmsnorm_init(dim, device),
        "q": linear_init(gen, dim, heads * dim_head, bias=False, device=device),
        "kv": linear_init(gen, dim_context, heads * dim_head * 2, bias=False, device=device),
        "out": linear_init(gen, heads * dim_head, dim, bias=False, device=device),
    }
    if null_kv:
        p["null_kv"] = torch.randn(2, heads, 1, dim_head, generator=gen, device=device)
    return p


def _ff_init(gen, dim, inner, device=None):
    return {"norm": rmsnorm_init(dim, device),
            "w1": linear_init(gen, dim, inner * 2, device=device),
            "w2": linear_init(gen, inner, dim, device=device)}


def init(gen: torch.Generator, cfg: T2SConfig, device=None):
    """Random parameters drawn from `gen`, with the early-exit draft head
    when `target_early_exit_layer > 0`."""
    device = device or gen.device
    rn = lambda *s: torch.randn(s, generator=gen, device=device)
    p = {
        "text_emb": embedding_init(gen, cfg.num_text_tokens + 1, cfg.text_emb_dim, device),
        "sem_emb": embedding_init(gen, cfg.num_semantic_tokens + 1, cfg.sem_emb_dim, device),
        "start_text": rn(cfg.dim),
        "start_speech": rn(cfg.target_dim),
        "source_final_norm": rmsnorm_init(cfg.dim, device),
        "target_final_norm": rmsnorm_init(cfg.target_dim, device),
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
    if cfg.target_early_exit_layer > 0:
        # Residual(FeedForward) -> RMSNorm -> Linear(V+1); the feed-forward's
        # inner width follows the reference head (mult 4), not target_ff_inner
        p["early_exit"] = {
            "ff": _ff_init(gen, cfg.target_dim, int(cfg.target_dim * 4 * 2 / 3), device=device),
            "norm": rmsnorm_init(cfg.target_dim, device),
            "to_logits": linear_init(gen, cfg.target_dim, cfg.num_semantic_tokens + 1, bias=False, device=device),
        }
        if cfg.two_output:   # a second full-width head drafts stream 2
            p["early_exit"]["to_logits2"] = linear_init(gen, cfg.target_dim, cfg.num_semantic_tokens + 1,
                                                        bias=False, device=device)
    return p


# ---------------------------------------------------------------------------
# blocks


def _ff(p, x, inner: int = 0, tp=None):
    """GEGLU feed-forward; `tp` with its `inner` pairs: on the rank's pairs
    where tp divides them, else with a split `w1` gathered."""
    split = TPX.divides(tp, inner)
    w1 = p["w1"] if split else TPX.full(tp, p["w1"], -1, 2 * inner, groups=2)
    h = L.linear(w1, TPX.enter(tp, L.rmsnorm(p["norm"], x), split))
    return TPX.row_linear(tp, p["w2"], L.geglu(h), split)


def _attn_weights(p, heads, dim_head, tp, names):
    """(split, the block's projections): the rank's head-aligned shards, or
    under tp without head-aligned shards each split one gathered."""
    split = TPX.divides(tp, heads)
    if split or not TPX.active(tp):
        return split, [p[n] for n in names]
    inner = heads * dim_head
    sizes = {"q": (-1, inner, 1), "kv": (-1, 2 * inner, 2), "out": (0, inner, 1)}
    return split, [TPX.full(tp, p[n], *sizes[n][:2], groups=sizes[n][2]) for n in names]


def _self_attn_full(p, x, heads, *, mask=None, causal=False, rotary=True, prefix_lens=None, dim_head=0, tp=None):
    """Full-sequence self-attention (training, encoder). With `prefix_lens`
    ([B] int, the per-row valid lengths of a right-padded batch) and no
    `mask`, it goes through `attend_flash_or_xla` (the flash kernels on CUDA
    from 512 positions on, also causal); a bool key `mask` [B, T] keeps
    `layers.attend`. `tp`: the rank's heads of `heads` x `dim_head`."""
    split, (wq, wkv, wout) = _attn_weights(p, heads, dim_head, tp, ("q", "kv", "out"))
    h = TPX.enter(tp, L.rmsnorm(p["norm"], x), split)
    if split:
        heads //= tp.tp
    q = L.split_heads(L.linear(wq, h), heads)
    k, v = torch.chunk(L.linear(wkv, h), 2, dim=-1)
    k, v = L.split_heads(k, heads), L.split_heads(v, heads)
    if rotary:
        inv = L.rotary_freqs(q.shape[-1], device=x.device)
        pos = torch.arange(x.shape[1], device=x.device)
        q, k = L.rotary_interleaved(pos, inv, q), L.rotary_interleaved(pos, inv, k)
    if prefix_lens is not None and mask is None:
        out = attend_flash_or_xla(q, k, v, valid_len=prefix_lens, causal=causal)
    else:
        out = L.attend(q, k, v, key_mask=mask, causal=causal)
    return TPX.row_linear(tp, wout, L.merge_heads(out), split)


def _cross_attn(p, x, context_kv, heads, *, context_mask=None, dim_head=0, tp=None):
    """Cross-attention with the learned null-KV slot prepended. context_kv:
    precomputed (k, v) [B, H, S, dh] without the null slot (`tp`: the
    rank's heads, from `_context_kv` with the same `tp`)."""
    split, (wq, wout) = _attn_weights(p, heads, dim_head, tp, ("q", "out"))
    h = TPX.enter(tp, L.rmsnorm(p["norm"], x), split)
    null_kv = TPX.heads_slice(tp, p["null_kv"], 1, heads) if split else p["null_kv"]
    if split:
        heads //= tp.tp
    q = L.split_heads(L.linear(wq, h), heads)
    k, v = context_kv
    b = x.shape[0]
    nk = null_kv[0].to(k.dtype).expand((b,) + tuple(null_kv[0].shape))
    nv = null_kv[1].to(v.dtype).expand((b,) + tuple(null_kv[1].shape))
    k = torch.cat([nk, k], dim=-2)
    v = torch.cat([nv, v], dim=-2)
    if context_mask is not None:
        context_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=x.device), context_mask], dim=-1)
    out = L.attend(q, k, v, key_mask=context_mask)
    return TPX.row_linear(tp, wout, L.merge_heads(out), split)


def _context_kv(p_cross, context, heads, *, dim_head=0, tp=None):
    split, (wkv,) = _attn_weights(p_cross, heads, dim_head, tp, ("kv",))
    if split:
        heads //= tp.tp
    k, v = torch.chunk(L.linear(wkv, TPX.enter(tp, context, split)), 2, dim=-1)
    return L.split_heads(k, heads), L.split_heads(v, heads)


def encode_source(params, cfg: T2SConfig, source_emb, source_mask, dtype=torch.float32, prefix_lens=None, tp=None):
    """Source transformer (non-causal, rotary) + final RMSNorm. `prefix_lens`:
    the per-row lengths of a right-padded batch in place of `source_mask`
    (see _self_attn_full). `tp`: tensor-parallel (module docstring)."""
    x = source_emb.to(dtype)
    if cfg.no_source_transformer:
        return x
    mask = None if prefix_lens is not None else source_mask
    for lp in params["source_layers"]:
        x = _self_attn_full(lp["self_attn"], x, cfg.heads, mask=mask, prefix_lens=prefix_lens,
                            dim_head=cfg.dim_head, tp=tp) + x
        x = _ff(lp["ff"], x, cfg.ff_inner, tp) + x
    return L.rmsnorm(params["source_final_norm"], x)


def embed_source(params, cfg: T2SConfig, source_ids, dtype=torch.float32, tp=None):
    """Token ids -> embeddings; two_input concatenates both streams. `tp`: a
    vocab-split table is gathered first."""
    ids = torch.clamp(source_ids, 0, cfg.num_text_tokens)
    table = {"w": TPX.full_leaf(tp, params["text_emb"]["w"], 0, cfg.num_text_tokens + 1)}
    if cfg.two_input:
        e1 = L.embedding(table, ids[..., 0], dtype)
        e2 = L.embedding(table, ids[..., 1], dtype)
        return torch.cat([e1, e2], dim=-1)
    return L.embedding(table, ids, dtype)


def _embed_target(params, cfg: T2SConfig, t1, t2, dtype, tp=None):
    table = {"w": TPX.full_leaf(tp, params["sem_emb"]["w"], 0, cfg.num_semantic_tokens + 1)}
    e = L.embedding(table, torch.clamp(t1, 0, cfg.num_semantic_tokens), dtype)
    if cfg.two_output:
        e2 = L.embedding(table, torch.clamp(t2, 0, cfg.num_semantic_tokens), dtype)
        e = torch.cat([e, e2], dim=-1)
    return e


def _sem_logits(params, h, dtype, tp=None, vocab: int = 0):
    """Weight-tied logits h @ emb^T (includes the EOS row), in f32. `tp`
    with the `vocab` rows split: the rank's columns, gathered."""
    if TPX.divides(tp, vocab):
        return TPX.gather_from_tp(tp, (TPX.copy_to_tp(tp, h) @ params["sem_emb"]["w"].to(dtype).T).float())
    return (h @ params["sem_emb"]["w"].to(dtype).T).float()


# ---------------------------------------------------------------------------
# training forward


def forward_loss(params, cfg: T2SConfig, source_ids, target_ids, *, generator: Optional[torch.Generator] = None,
                 source_mask=None, source_emb=None, cond_drop: bool = False, dtype=torch.float32,
                 return_logits: bool = False, mesh=None):
    """Teacher-forced CE. source_ids [B, S] (two_input: [B, S, 2]), or None
    with precomputed `source_emb` [B, S, dim] and its `source_mask`;
    target_ids [B, T] (two_output: [B, T, 2]) padded with the collate pad 501.
    semantic_pad_id -1 means every position counts in the CE. The decoder
    reads [BOS | targets with EOS]; logits[:, i] predicts target i, and the
    two-stream loss is the sum of both streams' CE. `cond_drop` with
    `classifier_free_guidance` replaces a row's context by the null source
    embedding with probability cond_drop_prob, drawn from `generator`.
    With `target_early_exit_layer` E > 0 and the `early_exit` head in
    `params`, the head's CE at the residual stream after decoder layer E is
    added (detached first with `detach_early_exit_embed`), and for
    two_output with `to_logits2` a second CE against stream 2.
    With `mesh` (parallel/mesh.py) the batch is one rank's rows of a global
    batch: the cond-drop draw is the global batch's, and each CE is
    sum(nll) x dp / the global count of valid targets (one all-reduce of the
    counts over the dp ranks), so that the dp ranks' mean is the one-device
    loss on the global batch; with its tp axis `params` are the rank's tp
    shards and the forward is tensor-parallel (module docstring). Returns
    the loss (0-dim f32), or (loss, logits) with `return_logits`
    (two_output: a pair of logits)."""
    tp = mesh if TPX.active(mesh) else None
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
        source_emb = embed_source(params, cfg, source_ids, dtype, tp=tp)
    context = encode_source(params, cfg, source_emb, source_mask, dtype, prefix_lens=src_lens, tp=tp)

    if cfg.classifier_free_guidance and cond_drop and generator is not None:
        b = context.shape[0]
        drop = torch.rand(b * (mesh.dp if mesh else 1), generator=generator, device=generator.device)
        drop = drop[mesh.rows(b) if mesh else slice(None)].to(context.device) < cfg.cond_drop_prob
        null = params["null_source_embedding"].to(dtype)[None, None, :]
        context = torch.where(drop[:, None, None], null, context)

    b = t1.shape[0]
    start = params["start_speech"].to(dtype)[None, None, :].expand(b, 1, cfg.target_dim)
    x = torch.cat([start, _embed_target(params, cfg, t1, t2, dtype, tp)], dim=1)
    hiddens = []
    dh = cfg.dim_head
    for lp in params["target_layers"]:
        x = _self_attn_full(lp["self_attn"], x, cfg.heads, causal=True, prefix_lens=dec_lens, dim_head=dh,
                            tp=tp) + x
        ckv = _context_kv(lp["cross_attn"], context, cfg.heads, dim_head=dh, tp=tp)
        x = _cross_attn(lp["cross_attn"], x, ckv, cfg.heads, context_mask=source_mask, dim_head=dh, tp=tp) + x
        x = _ff(lp["ff"], x, cfg.target_ff_inner, tp) + x
        hiddens.append(x)
    x = L.rmsnorm(params["target_final_norm"], x)

    counts = None
    if mesh is not None:
        counts = torch.stack([torch.sum(t1 != cfg.semantic_pad_id), torch.sum(t2 != cfg.semantic_pad_id)])
        mesh.all_reduce(counts)

    def ce(logits, tgt, stream):
        logits = logits[:, :-1]     # the last position predicts past the end
        valid = tgt != cfg.semantic_pad_id
        tgt_c = torch.clamp(tgt, 0, cfg.num_semantic_tokens).long()
        nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, tgt_c[..., None])[..., 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        if counts is None:
            return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
        return torch.sum(nll) / torch.clamp(counts[stream], min=1) * mesh.dp

    vocab = cfg.num_semantic_tokens + 1
    if cfg.two_output:
        half = cfg.target_dim // 2
        logits = (_sem_logits(params, x[..., :half], dtype, tp, vocab),
                  _sem_logits(params, x[..., half:], dtype, tp, vocab))
        loss = ce(logits[0], t1, 0) + ce(logits[1], t2, 1)
    else:
        logits = _sem_logits(params, x, dtype, tp, vocab)
        loss = ce(logits, t1, 0)

    # the early-exit draft head's CE, on the hidden states computed above
    if cfg.target_early_exit_layer > 0 and "early_exit" in params:
        early = hiddens[cfg.target_early_exit_layer - 1]
        if cfg.detach_early_exit_embed:
            early = early.detach()
        ee = params["early_exit"]
        hn = L.rmsnorm(ee["norm"], early + _ff(ee["ff"], early, int(cfg.target_dim * 4 * 2 / 3), tp))
        loss = loss + ce(L.linear(ee["to_logits"], hn).float(), t1, 0)
        if cfg.two_output and "to_logits2" in ee:
            loss = loss + ce(L.linear(ee["to_logits2"], hn).float(), t2, 1)
    if return_logits:
        return loss, logits
    return loss


# ---------------------------------------------------------------------------
# the one-program decode: one step over static buffers, driven in chunks
#
# `generate` and `generate_speculative` keep every tensor a step reads or
# writes in buffers allocated before the loop (`_Decode`): the per-layer KV
# caches, the token buffers, the stop flags and a device step counter. The
# step attends over the whole cache under a position mask, as the JAX
# while_loop does, and ends by writing `read` = [continue, count]. The host
# runs the step STEPS_PER_READ times (ROUNDS_PER_READ speculative rounds)
# between two reads of that pair; after the stop a step changes nothing the
# result reads, so the extra steps of the last chunk are no-ops. On CUDA the
# step is captured once per shape as a CUDA graph and replayed (a capture or
# replay failure raises); on the CPU the same step function runs directly.

STEPS_PER_READ = 8      # greedy steps between two host reads of the stop flag
ROUNDS_PER_READ = 2     # speculative rounds between two host reads
GRAPH_CACHE_SIZE = 16   # captured decodes kept, least recently used dropped
# False runs the step uncaptured on CUDA too: the yardstick that
# chip_smoke.py times the graphs against, never a fallback
CAPTURE = True
# a step count at which every decode stops, as if it had been cut there (None:
# none); chip_smoke.py holds the direct step against the graph on a prefix of
# the very program it times over the whole decode
STOP_AFTER: Optional[int] = None

_GRAPHS: "collections.OrderedDict[tuple, _Decode]" = collections.OrderedDict()


class DecodeCounts:
    """The decodes' counts in this process, each a plain integer that goes
    up where its event happens (as ops/flash_attention.KERNEL counts
    launches): `captures`, decodes built and captured as a CUDA graph;
    `evictions`, captured decodes dropped from `_GRAPHS` (least recently
    used first); `replays`, graph replays (a step or a speculative round
    each; steps run directly, on the CPU or with CAPTURE off, are not
    replays); `reads`, host reads of the stop flag (one a chunk of steps)."""

    def __init__(self):
        self.captures = self.evictions = self.replays = self.reads = 0

    def __str__(self):
        return (f"decode graphs: {self.captures} captured, {self.evictions} evicted, {self.replays} replays, "
                f"{self.reads} host reads")


DECODE = DecodeCounts()


class GenerateResult(NamedTuple):
    tokens: torch.Tensor       # [B, L] stream-1 tokens, pad-filled after EOS
    tokens2: torch.Tensor      # [B, L] stream-2 (== tokens when not two_output)
    lengths: torch.Tensor      # [B] decoded positions (incl. EOS)
    lengths2: torch.Tensor
    num_steps: int             # decode iterations executed


class _Decode:
    """One decode's buffers and step. `inputs`: what a call brings (the
    decoder's weights in the compute dtype, the cross-attention K/V, the
    source mask); `state`: what the steps carry, reset by `reset` to
    `initial` ({name: fill value}; caches to zero), with `read`, the
    [continue, count] pair every step writes last. `generator` is the one
    the step draws its noise from (None: no noise)."""

    def __init__(self, step, inputs, state, initial, generator=None):
        self.step, self.inputs, self.state, self.initial = step, inputs, state, initial
        self.generator = generator
        self.graph = None
        self.capture_s = 0.0

    def reset(self):
        for name, value in self.initial.items():
            for t in tree_leaves(self.state[name]):
                t.fill_(value)

    def capture(self):
        """Warm the step up on a side stream, then capture it as a CUDA graph
        with the generator's state registered, so every replay draws fresh
        noise from where the generator stands."""
        if self.generator is not None and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(f"torch {torch.__version__} cannot register a generator with a CUDA graph "
                               "(CUDAGraph.register_generator_state); a captured decode would replay one draw")
        dev = self.state["read"].device
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            with torch.cuda.graph(graph):
                self.step()
            torch.cuda.synchronize()
        self.graph, self.capture_s = graph, time.perf_counter() - t0


def _cast_weights(tree, dtype):
    """The decoder's parameters in the compute dtype, once per call; the norm
    gains stay as they are (rmsnorm computes in f32). What `layers.linear`
    and the embedding would cast at every use, cast once."""
    if isinstance(tree, dict):
        return {k: (v if k == "gamma" else _cast_weights(v, dtype)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cast_weights(v, dtype) for v in tree]
    return tree.to(dtype)


@profiling.scoped("t2s.prepare")
def _prepared(key, build, inputs, dtype, dev, generator):
    """The decode for this call, its inputs in place and its state reset. On
    the CPU (and on CUDA with CAPTURE off) `build(inputs, generator)` makes it
    around this call's tensors. On CUDA the decode cached under `key` (the
    call's shapes, dtype and flags) is reused, this call's inputs copied into
    its static buffers; a new key is built on clones, warmed up and captured,
    with a generator of its own when the step draws noise."""
    w = inputs["w"]
    if dev.type != "cuda" or not CAPTURE:
        dec = build(dict(inputs, w=_cast_weights(w, dtype)), generator)
    else:
        dec = _GRAPHS.pop(key, None)
        if dec is None:
            with profiling.scope("t2s.capture", key[2], *key[3]):     # rows, context shape
                static = tree_map(torch.clone, dict(inputs, w=_cast_weights(w, dtype)))
                dec = build(static, None if generator is None else torch.Generator(device=dev))
                dec.capture()
            DECODE.captures += 1
            while len(_GRAPHS) >= GRAPH_CACHE_SIZE:
                _GRAPHS.popitem(last=False)
                DECODE.evictions += 1
        else:
            for buf, src in zip(tree_leaves(dec.inputs), tree_leaves(inputs)):
                buf.copy_(src)          # the weights cast on the way in
        _GRAPHS[key] = dec
    dec.reset()
    return dec


def _drive(dec, per_read, redraw=None, decide=None):
    """Run the step `per_read` times between reads of `read` until one says
    stop, or the count reaches STOP_AFTER; returns the count. With `redraw(n)` (n steps' noise draws), the
    generator ends where the steps taken leave it: each chunk starts from a
    snapshot, and a chunk that stopped early restores it and redraws its
    live steps. `decide(read) -> (continue, count)` reads the chunk's
    `read` where it is not [continue, count] itself (over dp: a collective
    of the ranks' reads)."""
    run = dec.step if dec.graph is None else dec.graph.replay
    gen = dec.generator if redraw is not None else None
    decide = decide or (lambda read: read.tolist())
    replays = per_read if dec.graph is not None else 0
    count = 0
    while True:
        snap = gen.get_state() if gen is not None else None
        for _ in range(per_read):   # no range here: one a chunk would double the ranges of a trace
            run()
        DECODE.replays += replays
        with profiling.scope("t2s.read"):
            cont, now = decide(dec.state["read"])      # the chunk's one host read
        DECODE.reads += 1
        if not cont or (STOP_AFTER is not None and now >= STOP_AFTER):
            break
        count = now
    if gen is not None and now - count < per_read:
        gen.set_state(snap)
        redraw(now - count)
    return now


def _build_generate(cfg: T2SConfig, b, bb, max_length, dtype, use_cfg, cond_scale, temperature, top_k_thres,
                    min_length, no_repeat_ngram_size, inputs, generator, rows=None) -> _Decode:
    """The greedy / top-k decode's buffers and step (the JAX body). `rows`
    ((global rows, this rank's slice)): the rows of a dp rank, which draws
    the noise of the global batch, keeps its slice, and steps on until the
    host's read of every rank says stop (the step records, per stream, the
    step count at which all of its rows were done, `max_length` + 1 until
    then, and `read` is [those two, the count])."""
    heads, dh = cfg.heads, cfg.dim_head
    eos, pad, two = cfg.semantic_eos_id, cfg.semantic_pad_id, cfg.two_output
    dev = inputs["mask"].device
    w, cross, source_mask = inputs["w"], inputs["cross"], inputs["mask"]
    inv = L.rotary_freqs(dh, device=dev)
    key_pos = torch.arange(max_length, device=dev)
    eos_col = torch.arange(cfg.num_semantic_tokens + 1, device=dev) == eos
    st = {"k": [torch.zeros((bb, heads, max_length, dh), dtype=dtype, device=dev) for _ in w["target_layers"]],
          "v": [torch.zeros((bb, heads, max_length, dh), dtype=dtype, device=dev) for _ in w["target_layers"]],
          "tokens1": torch.full((b, max_length), pad, dtype=torch.int32, device=dev),
          "done1": torch.zeros(b, dtype=torch.bool, device=dev),
          "step": torch.zeros((), dtype=torch.long, device=dev),
          "read": torch.zeros(2 if rows is None else 3, dtype=torch.long, device=dev)}
    st["tokens2"] = torch.full_like(st["tokens1"], pad) if two else st["tokens1"]
    st["done2"] = torch.zeros_like(st["done1"]) if two else st["done1"]
    initial = {"k": 0, "v": 0, "tokens1": pad, "tokens2": pad, "done1": 0, "done2": 0, "step": 0, "read": 0}
    if rows is not None:
        st["at"] = torch.full((2,), max_length + 1, dtype=torch.long, device=dev)
        initial["at"] = max_length + 1
    dec = _Decode(None, inputs, st, initial, generator)

    def stopped():
        return (st["done1"].all() | st["done2"].all()) if two else st["done1"].all()

    def put(tokens, at, live, s):
        tokens.index_copy_(1, at, torch.where(live, s, tokens.index_select(1, at)[:, 0])[:, None])

    def logits(h):
        if two:
            half = cfg.target_dim // 2
            return _sem_logits(w, h[..., :half], dtype), _sem_logits(w, h[..., half:], dtype)
        lg = _sem_logits(w, h, dtype)
        return lg, lg

    def sample(lg):
        if rows is None:
            return S.gumbel_sample(dec.generator, lg, temperature).to(torch.int32)
        return S.gumbel_sample(dec.generator, lg, temperature, rows=rows).to(torch.int32)

    def step():
        i = st["step"]
        # a dp rank does not know the other ranks' rows: it steps on, and the host cuts at the global stop
        live = (i < max_length) if rows is not None else ~stopped() & (i < max_length)
        at = torch.clamp(i, max=max_length - 1).view(1)       # a step past the end writes in bounds, gated
        prev = torch.clamp(i - 1, min=0).view(1)
        e = _embed_target(w, cfg, st["tokens1"].index_select(1, prev)[:, 0],
                          st["tokens2"].index_select(1, prev)[:, 0], dtype)
        x = torch.where(i == 0, w["start_speech"][None, :], e)
        if use_cfg:
            x = torch.cat([x, x], dim=0)
        x = x[:, None, :]
        pos = i.view(1)
        kmask = (key_pos <= i)[None, :].expand(bb, -1)
        for li, lp in enumerate(w["target_layers"]):
            sa = lp["self_attn"]
            h = L.rmsnorm(sa["norm"], x)
            q = L.split_heads(L.linear(sa["q"], h), heads)
            k_new, v_new = torch.chunk(L.linear(sa["kv"], h), 2, dim=-1)
            k_new, v_new = L.split_heads(k_new, heads), L.split_heads(v_new, heads)
            st["k"][li].index_copy_(2, at, L.rotary_interleaved(pos, inv, k_new))
            st["v"][li].index_copy_(2, at, v_new)
            att = L.attend(L.rotary_interleaved(pos, inv, q), st["k"][li], st["v"][li], key_mask=kmask)
            x = L.linear(sa["out"], L.merge_heads(att)) + x
            x = _cross_attn(lp["cross_attn"], x, cross[li], heads, context_mask=source_mask) + x
            x = _ff(lp["ff"], x) + x
        lg1, lg2 = logits(L.rmsnorm(w["target_final_norm"], x)[:, 0])
        if use_cfg:
            lg1 = lg1[b:] + (lg1[:b] - lg1[b:]) * cond_scale
            lg2 = lg2[b:] + (lg2[:b] - lg2[b:]) * cond_scale
        if min_length > 0:
            ban = eos_col[None, :] & (i < min_length)
            lg1, lg2 = lg1.masked_fill(ban, S.NEG_INF), lg2.masked_fill(ban, S.NEG_INF)
        if no_repeat_ngram_size > 0:
            lg1 = S.ban_repeated_ngrams(lg1, st["tokens1"], i, no_repeat_ngram_size)
            if two:
                lg2 = S.ban_repeated_ngrams(lg2, st["tokens2"], i, no_repeat_ngram_size)
        s1 = sample(S.top_k_filter(lg1, thres=top_k_thres))
        put(st["tokens1"], at, live, s1)
        st["done1"] |= live & (s1 == eos)
        if two:
            s2 = sample(S.top_k_filter(lg2, thres=top_k_thres))
            put(st["tokens2"], at, live, s2)
            st["done2"] |= live & (s2 == eos)
        i += live
        if rows is None:
            st["read"].copy_(torch.stack([(~stopped() & (i < max_length)).long(), i]))
            return
        done = torch.stack([st["done1"].all(), st["done2"].all()])
        st["at"].copy_(torch.where((st["at"] > max_length) & done, i, st["at"]))
        st["read"].copy_(torch.cat([st["at"], i.view(1)]))

    dec.step = step
    return dec


@torch.no_grad()
@profiling.scoped("t2s.generate")
def generate(params, cfg: T2SConfig, generator: Optional[torch.Generator], source_ids, *,
             max_length: int = 2048, temperature: float = 1.0, top_k_thres: float = 0.1,
             cond_scale: float = 1.0, min_length: int = 0, no_repeat_ngram_size: int = 0,
             source_emb=None, source_mask=None, dtype=torch.float32, mesh=None) -> GenerateResult:
    """Top-k + Gumbel AR decode of up to max_length steps. Stops when every
    row has emitted EOS (two_output: when either stream has). After a stop,
    positions after EOS become pad; positions never written are pad either way.
    `min_length` masks the EOS logit for the first min_length steps. The
    noise comes from `generator` (None: the device's default one), which the
    call leaves where num_steps eager steps would. The source is encoded
    eagerly; the decode runs as one captured step on CUDA (see `_Decode`).

    With `mesh` (parallel/mesh.py) the rows are one dp rank's share of a
    global batch: each step draws the noise of the global batch and keeps
    the rank's rows, and the stop is decided over dp at each host read
    (one all-reduce of the ranks' stop steps), so every rank runs the
    global step count, each row's tokens are the one-device call's on the
    global batch, and the generator ends where that call leaves it."""
    b = (source_ids if source_emb is None else source_emb).shape[0]
    with profiling.scope("t2s.encode"):     # source embed, encoder, cross K / V
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
            source_mask = torch.cat([source_mask, torch.zeros_like(source_mask)], dim=0)
        bb = context.shape[0]
        if generator is None:
            generator = torch.default_generator if dev.type == "cpu" else torch.cuda.default_generators[
                dev.index if dev.index is not None else torch.cuda.current_device()]
        inputs = {"w": {k: params[k] for k in ("target_layers", "target_final_norm", "sem_emb", "start_speech")},
                  "cross": [_context_kv(lp["cross_attn"], context, cfg.heads) for lp in params["target_layers"]],
                  "mask": source_mask}
    flags = (max_length, temperature, top_k_thres, cond_scale, min_length, no_repeat_ngram_size)
    rows = None if mesh is None else (b * mesh.dp, mesh.rows(b))
    key = ("generate", cfg, b, tuple(context.shape), str(dev), dtype) + flags + (rows and (rows[0], rows[1].start),)
    dec = _prepared(key, lambda inp, gen: _build_generate(cfg, b, bb, max_length, dtype, use_cfg, cond_scale,
                                                          temperature, top_k_thres, min_length,
                                                          no_repeat_ngram_size, inp, gen, rows),
                    inputs, dtype, dev, generator)
    if dec.generator is not generator:      # a captured decode draws from its own generator
        dec.generator.set_state(generator.get_state())
    shape = (b if rows is None else rows[0], cfg.num_semantic_tokens + 1)
    draws = 2 if cfg.two_output else 1

    def redraw(n):
        for _ in range(n * draws):
            S.gumbel_noise(dec.generator, shape, dev)

    stop = {}

    def decide(read):
        """The global stop: the step count at which every rank's rows of a
        stream were done (the max over dp), the earlier of the two streams'."""
        at = read.clone()
        dist.all_reduce(at, op=dist.ReduceOp.MAX, group=mesh.dp_group)
        at1, at2, now = at.tolist()
        stop["at"] = min(at1, at2) if cfg.two_output else at1
        return stop["at"] > now and now < max_length, min(now, stop["at"])

    num_steps = _drive(dec, STEPS_PER_READ, redraw, None if mesh is None else decide)
    if dec.generator is not generator:
        generator.set_state(dec.generator.get_state())

    with profiling.scope("t2s.finish"):     # after-EOS masking, lengths
        st = dec.state
        eos, pad = cfg.semantic_eos_id, cfg.semantic_pad_id
        tokens1, tokens2 = st["tokens1"], st["tokens2"]
        # the reference masks after EOS only when the loop stopped on EOS
        if mesh is None:
            stopped = (st["done1"].all() | st["done2"].all()) if cfg.two_output else st["done1"].all()
        else:       # the steps a rank ran past the global stop are cut
            stopped = torch.tensor(stop["at"] <= max_length, device=dev)
            kept = torch.arange(max_length, device=dev)[None, :] < num_steps
            tokens1, tokens2 = torch.where(kept, tokens1, pad), torch.where(kept, tokens2, pad)
        tokens1 = torch.where(stopped, S.mask_after_eos(tokens1, eos, pad), tokens1)
        tokens2 = torch.where(stopped, S.mask_after_eos(tokens2, eos, pad), tokens2)
        return GenerateResult(tokens1, tokens2, torch.sum(tokens1 != pad, dim=-1), torch.sum(tokens2 != pad, dim=-1),
                              num_steps)


# ---------------------------------------------------------------------------
# self-speculative decode through the early-exit head
#
# Draft gamma tokens with decoder layers 1..E and the early-exit head, then
# verify every draft in ONE full-depth forward over gamma+1 positions and
# accept the longest matching prefix plus the full model's bonus token. The
# tokens are greedy `generate`'s; only the number of full-depth forwards
# changes, with the draft's acceptance.


def _write_cache_at(cache, new, offsets):
    """cache [B, H, L, dh] <- new [B, H, S, dh] at positions offsets[b] +
    [0..S) of each row b, in place: one scatter over a [B, S] index."""
    b, h, s, dh = new.shape
    pos = offsets[:, None] + torch.arange(s, device=new.device)[None, :]
    return cache.scatter_(2, pos[:, None, :, None].expand(b, h, s, dh), new)


def _build_speculative(cfg: T2SConfig, b, max_length, gamma, dtype, inputs, generator=None) -> _Decode:
    """The speculative decode's buffers and round (the JAX body_fn)."""
    heads, dh = cfg.heads, cfg.dim_head
    eos, pad, two = cfg.semantic_eos_id, cfg.semantic_pad_id, cfg.two_output
    cl = max_length + gamma + 2  # cache length, with room for the drafts in flight
    dev = inputs["mask"].device
    w, cross, source_mask = inputs["w"], inputs["cross"], inputs["mask"]
    layers, ee = w["target_layers"], w["early_exit"]
    inv = L.rotary_freqs(dh, device=dev)
    pos_idx = torch.arange(cl, device=dev)
    span_idx = torch.arange(gamma + 1, device=dev)
    st = {"k": [torch.zeros((b, heads, cl, dh), dtype=dtype, device=dev) for _ in layers],
          "v": [torch.zeros((b, heads, cl, dh), dtype=dtype, device=dev) for _ in layers],
          "tokens1": torch.full((b, cl), pad, dtype=torch.int32, device=dev),
          "lens": torch.zeros(b, dtype=torch.long, device=dev),     # positions accepted per row
          "done1": torch.zeros(b, dtype=torch.bool, device=dev),    # stream EOS flags (EOS only, as in generate)
          # first-EOS position per row and stream (cl = none yet), to rebuild
          # generate's GLOBAL stop step I = min over streams of (max over rows
          # of the first EOS) + 1 after the loop: rows that have no EOS by I
          # are cut there, as the global loop cuts them
          "p1": torch.full((b,), cl, dtype=torch.long, device=dev),
          "it": torch.zeros((), dtype=torch.long, device=dev),
          "read": torch.zeros(2, dtype=torch.long, device=dev)}
    for name in ("tokens", "done", "p"):
        st[f"{name}2"] = st[f"{name}1"].clone() if two else st[f"{name}1"]
    dec = _Decode(None, inputs, st, {"k": 0, "v": 0, "tokens1": pad, "tokens2": pad, "lens": 0, "done1": 0,
                                     "done2": 0, "p1": cl, "p2": cl, "it": 0, "read": 0})
    start = w["start_speech"][None, :]

    def layer(li, x, start_b):
        """Decoder layer li over x [B, S, D] at positions start_b + [0..S)
        per row. Writes those positions of the layer's cache, then attends
        causally over the whole cache: a query at p sees keys <= p, so the
        stale entries a rejected draft left past a row's position stay
        masked until the verify overwrites them."""
        lp = layers[li]
        sa = lp["self_attn"]
        h = L.rmsnorm(sa["norm"], x)
        q = L.split_heads(L.linear(sa["q"], h), heads)
        k_new, v_new = torch.chunk(L.linear(sa["kv"], h), 2, dim=-1)
        k_new, v_new = L.split_heads(k_new, heads), L.split_heads(v_new, heads)
        qpos = start_b[:, None] + torch.arange(x.shape[1], device=dev)[None, :]       # [B, S]
        q = L.rotary_interleaved(qpos[:, None], inv, q)     # per-row positions (JAX: _rotary_at(_span))
        ck = _write_cache_at(st["k"][li], L.rotary_interleaved(qpos[:, None], inv, k_new), start_b)
        cv = _write_cache_at(st["v"][li], v_new, start_b)
        kmask = pos_idx[None, None, :] <= qpos[:, :, None]                             # [B, S, cl]
        sim = torch.einsum("bhid,bhjd->bhij", q, ck).float() * dh ** -0.5
        att = torch.nan_to_num(torch.softmax(sim.masked_fill(~kmask[:, None], float("-inf")), dim=-1), nan=0.0)
        x = L.linear(sa["out"], L.merge_heads(torch.einsum("bhij,bhjd->bhid", att.to(cv.dtype), cv))) + x
        x = _cross_attn(lp["cross_attn"], x, cross[li], heads, context_mask=source_mask) + x
        return _ff(lp["ff"], x) + x

    def draft(prev1, prev2, pos_b):
        """Layers 1..E and the draft head(s) at position pos_b [B] per row."""
        e = _embed_target(w, cfg, prev1, prev2, dtype)
        x = torch.where((pos_b == 0)[:, None], start, e)[:, None, :]
        for li in range(cfg.target_early_exit_layer):
            x = layer(li, x, pos_b)
        hn = L.rmsnorm(ee["norm"], x + _ff(ee["ff"], x))
        t1 = torch.argmax(L.linear(ee["to_logits"], hn).float()[:, 0], dim=-1).to(torch.int32)
        if not two:
            return t1, t1
        return t1, torch.argmax(L.linear(ee["to_logits2"], hn).float()[:, 0], dim=-1).to(torch.int32)

    def verify(in1, in2):
        """The full depth over the gamma+1 positions lens..lens+gamma per row,
        inputs [token at lens-1 (BOS at 0), drafts...]; overwrites every
        layer's cache there. Returns the greedy tokens [B, gamma+1] per stream."""
        lens = st["lens"]
        x = _embed_target(w, cfg, in1, in2, dtype)
        x[:, 0] = torch.where((lens == 0)[:, None], start, x[:, 0])
        for li in range(len(layers)):
            x = layer(li, x, lens)
        x = L.rmsnorm(w["target_final_norm"], x)
        if not two:
            f1 = torch.argmax(_sem_logits(w, x, dtype), dim=-1).to(torch.int32)
            return f1, f1
        half = cfg.target_dim // 2
        return (torch.argmax(_sem_logits(w, x[..., :half], dtype), dim=-1).to(torch.int32),
                torch.argmax(_sem_logits(w, x[..., half:], dtype), dim=-1).to(torch.int32))

    def first_eos(full, take, done, p):
        hit = (full == eos) & take
        any_hit = hit.any(dim=1)
        first = torch.argmax(hit.to(torch.int32), dim=1)                    # the first True
        p.copy_(torch.where(any_hit & ~done, st["lens"] + first, p))
        done |= any_hit

    def live_rows():
        # a row is live until BOTH its streams emitted EOS (generate decodes
        # both streams until its GLOBAL stop, which is rebuilt after the loop)
        return ~(st["done1"] & st["done2"]) & (st["lens"] < max_length)

    def round_():
        lens, it, tokens1, tokens2 = st["lens"], st["it"], st["tokens1"], st["tokens2"]
        active = live_rows()
        go = active.any() & (it < max_length)       # the JAX cond_fn; a round after it is a no-op
        active &= go
        prev_pos = torch.clamp(lens - 1, min=0)[:, None]
        prev1, prev2 = torch.gather(tokens1, 1, prev_pos)[:, 0], torch.gather(tokens2, 1, prev_pos)[:, 0]
        drafts1, drafts2, t1, t2 = [], [], prev1, prev2
        for j in range(gamma):
            t1, t2 = draft(t1, t2, lens + j)
            drafts1.append(t1)
            drafts2.append(t2)
        drafts1, drafts2 = torch.stack(drafts1, dim=1), torch.stack(drafts2, dim=1)
        full1, full2 = verify(torch.cat([prev1[:, None], drafts1], dim=1),
                              torch.cat([prev2[:, None], drafts2], dim=1))
        # the longest JOINTLY matching prefix, plus the bonus position
        match = drafts1 == full1[:, :gamma]
        if two:
            match &= drafts2 == full2[:, :gamma]
        n_acc = torch.sum(torch.cumprod(match.to(torch.int32), dim=1), dim=1)
        take = (span_idx[None, :] <= n_acc[:, None]) & active[:, None]      # [B, gamma+1]
        # the accepted drafts equal the verify's tokens, and the bonus is the
        # verify's: write full[:, :n_acc+1] at lens.. (untaken slots unchanged)
        idx = lens[:, None] + span_idx[None, :]
        tokens1.scatter_(1, idx, torch.where(take, full1, torch.gather(tokens1, 1, idx)))
        first_eos(full1, take, st["done1"], st["p1"])
        if two:
            tokens2.scatter_(1, idx, torch.where(take, full2, torch.gather(tokens2, 1, idx)))
            first_eos(full2, take, st["done2"], st["p2"])
        lens.copy_(torch.clamp(lens + torch.where(active, n_acc + 1, 0), max=max_length))
        it += go
        st["read"].copy_(torch.stack([(live_rows().any() & (it < max_length)).long(), it]))

    dec.step = round_
    return dec


@torch.no_grad()
def generate_speculative(params, cfg: T2SConfig, source_ids, *, max_length: int = 2048, gamma: int = 4,
                         dtype=torch.float32) -> GenerateResult:
    """Greedy speculative decode through the early-exit head, single-stream
    and CoMix two_output. Needs cfg.target_early_exit_layer E > 0 and
    params['early_exit'] (for two_output also its 'to_logits2': released
    checkpoints carry only the stream-1 head). Each round drafts gamma
    tokens (pairs) one after another with decoder layers 1..E and the draft
    head(s) (argmax), verifies them in one full-depth forward over gamma+1
    positions per row, and accepts the longest prefix on which BOTH streams
    match plus the full model's bonus token (joint acceptance: stream 2's
    continuation reads stream 1's tokens through the concatenated
    embedding). The tokens equal greedy `generate`'s; `num_steps` counts the
    verify rounds. The rounds run ROUNDS_PER_READ at a time between reads of
    the stop flag, captured as one CUDA graph on CUDA (see `_Decode`).
    (The JAX signature; `generate_speculative_rows` takes a dp mesh.)"""
    return generate_speculative_rows(params, cfg, source_ids, None, max_length=max_length, gamma=gamma, dtype=dtype)


@torch.no_grad()
@profiling.scoped("t2s.generate")
def generate_speculative_rows(params, cfg: T2SConfig, source_ids, mesh, *, max_length: int = 2048, gamma: int = 4,
                              dtype=torch.float32) -> GenerateResult:
    """`generate_speculative` of one dp rank's rows of a global batch over
    `mesh` (parallel/mesh.py; None: the whole batch). A row's rounds depend
    on its own tokens alone; the stop read and the global stop step are
    decided over dp (all-reduces of the ranks' flags and first-EOS
    positions), and `num_steps` is the global batch's rounds."""
    if cfg.two_input:
        raise AssertionError("speculative decode: two_input not supported")
    if not (cfg.target_early_exit_layer > 0 and "early_exit" in params):
        raise AssertionError("needs the early-exit head")
    two = cfg.two_output
    if two and "to_logits2" not in params["early_exit"]:
        raise AssertionError("two_output speculative decode needs the stream-2 draft head "
                             "(train with this framework; reference checkpoints carry only stream 1)")
    b, dev = source_ids.shape[0], source_ids.device
    eos, pad = cfg.semantic_eos_id, cfg.semantic_pad_id

    with profiling.scope("t2s.encode"):
        src = S.set_eos_id(source_ids, cfg.text_eos_id, cfg.text_pad_id)
        source_mask = src != cfg.text_pad_id
        context = encode_source(params, cfg, embed_source(params, cfg, src, dtype), source_mask, dtype)
        names = ("target_layers", "target_final_norm", "sem_emb", "start_speech", "early_exit")
        inputs = {"w": {k: params[k] for k in names},
                  "cross": [_context_kv(lp["cross_attn"], context, cfg.heads) for lp in params["target_layers"]],
                  "mask": source_mask}
    key = ("speculative", cfg, b, tuple(context.shape), str(dev), dtype, max_length, gamma)
    dec = _prepared(key, lambda inp, gen: _build_speculative(cfg, b, max_length, gamma, dtype, inp),
                    inputs, dtype, dev, None)

    def over_dp(values):
        """The max over the dp ranks of a [n] long tensor."""
        values = values.clone()
        dist.all_reduce(values, op=dist.ReduceOp.MAX, group=mesh.dp_group)
        return values

    rounds = _drive(dec, ROUNDS_PER_READ, decide=None if mesh is None else lambda read: over_dp(read).tolist())

    with profiling.scope("t2s.finish"):
        st = dec.state
        # generate's global stop: it halts after the step where ALL rows emitted
        # EOS on stream 1 OR all rows on stream 2, so positions >= I = min(max_r
        # p1, max_r p2) + 1 were never decoded there
        done1, done2 = st["done1"].all(), st["done2"].all()
        p1, p2 = st["p1"].max(), st["p2"].max()
        if mesh is not None:        # over the global batch's rows: done on every rank, the last first EOS
            g = over_dp(torch.stack([(~done1).long(), (~done2).long(), p1, p2]))
            done1, done2, p1, p2 = g[0] == 0, g[1] == 0, g[2], g[3]
        i1 = torch.where(done1, p1 + 1, max_length)
        i2 = torch.where(done2, p2 + 1, max_length) if two else i1
        pos_idx = torch.arange(max_length, device=dev)
        valid = pos_idx[None, :] < torch.clamp(torch.minimum(i1, i2), max=max_length)
        tokens1 = torch.where(valid, st["tokens1"][:, :max_length], pad)
        tokens2 = torch.where(valid, st["tokens2"][:, :max_length], pad)
        stopped = (done1 | done2) if two else done1
        # generate masks after EOS only when its loop stopped on EOS
        tokens1 = torch.where(stopped, S.mask_after_eos(tokens1, eos, pad), tokens1)
        tokens2 = torch.where(stopped, S.mask_after_eos(tokens2, eos, pad), tokens2)
        return GenerateResult(tokens1, tokens2, torch.sum(tokens1 != pad, dim=-1), torch.sum(tokens2 != pad, dim=-1),
                              rounds)


# ---------------------------------------------------------------------------
# auxiliary training losses


def semantic_to_text_loss(params, cfg: T2SConfig, semantic_ids, text_ids, *, dtype=torch.float32):
    """Back-translation: the speech tokens through the SPEECH embedding and
    the encoder, the text through the text embedding, the decoder and the
    weight-tied text logits; CE over the text (pad 0 ignored). Needs
    target_dim == dim and neither two_output nor two_input."""
    if cfg.target_dim != cfg.dim:
        raise AssertionError("s2t decoding shares the decoder; set target_dim == dim")
    if cfg.two_output or cfg.two_input:
        raise AssertionError("s2t decoding takes one speech and one text stream")
    src = S.set_eos_id(semantic_ids, cfg.semantic_eos_id, cfg.semantic_pad_id)
    source_mask = src != cfg.semantic_pad_id
    source_emb = L.embedding(params["sem_emb"], torch.clamp(src, 0, cfg.num_semantic_tokens), dtype)
    context = encode_source(params, cfg, source_emb, source_mask, dtype)

    tgt = S.set_eos_id(text_ids, cfg.text_eos_id, cfg.text_pad_id)
    valid = tgt != cfg.text_pad_id
    b = tgt.shape[0]
    dec_mask = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=tgt.device), valid], dim=-1)
    start = params["start_text"].to(dtype)[None, None, :].expand(b, 1, cfg.dim)
    x = torch.cat([start, L.embedding(params["text_emb"], torch.clamp(tgt, 0, cfg.num_text_tokens), dtype)], dim=1)
    for lp in params["target_layers"]:
        x = _self_attn_full(lp["self_attn"], x, cfg.heads, mask=dec_mask, causal=True) + x
        ckv = _context_kv(lp["cross_attn"], context, cfg.heads)
        x = _cross_attn(lp["cross_attn"], x, ckv, cfg.heads, context_mask=source_mask) + x
        x = _ff(lp["ff"], x) + x
    x = L.rmsnorm(params["target_final_norm"], x)
    logits = (x @ params["text_emb"]["w"].to(dtype).T).float()[:, :-1]
    tgt_c = torch.clamp(tgt, 0, cfg.num_text_tokens).long()
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, tgt_c[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)


def speech_speech_pretrain_loss(params, cfg: T2SConfig, generator: Optional[torch.Generator], semantic_ids, *,
                                deletion_prob: float = 0.6, dtype=torch.float32, drop=None, mesh=None):
    """Denoising pretraining: a random `deletion_prob` share of the speech
    tokens is replaced with the mask id (the last text id), and the model
    reconstructs the whole sequence; the corrupted tokens go through the TEXT
    path. The draw comes from `generator` (with `mesh`, the global batch's,
    as in `forward_loss`), or is handed in as `drop` ([B, T] bool, True =
    replace; pad positions are never replaced)."""
    mask_id = cfg.num_text_tokens - 1
    valid = semantic_ids != cfg.semantic_pad_id
    if drop is None:
        b = semantic_ids.shape[0]
        u = torch.rand((b * (mesh.dp if mesh else 1), *semantic_ids.shape[1:]), generator=generator,
                       device=generator.device)
        drop = u[mesh.rows(b) if mesh else slice(None)].to(semantic_ids.device) < deletion_prob
    drop = drop & valid
    source = torch.where(drop, mask_id, torch.clamp(semantic_ids, 0, cfg.num_text_tokens - 1))
    return forward_loss(params, cfg, source, semantic_ids, dtype=dtype, mesh=mesh)

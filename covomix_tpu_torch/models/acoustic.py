"""Voicebox-style flow-matching acoustic model (VoSingle / VoMix): port of
covomix_tpu/models/acoustic.py (inference and the OT-CFM training loss).

  * transformer: concat [noisy mel x_t, phoneme emb, cond mel] -> Linear ->
    depthwise-conv positional embed -> U-Net-skip transformer with halfsplit
    rotary and adaptive RMSNorm on a learned-sinusoidal time embedding ->
    Linear to mel
  * sampler: 16 midpoint steps, the ODE state kept in f32 while the model
    computes in `dtype`; CFG runs the cond and null rows as one doubled batch
    and combines them as logits*(1+s) - s*null. `sample_adaptive` integrates
    the same field with adaptive Tsit5 steps, `sample_regression` is one
    forward at a random time.

Attention goes through `attend_flash_or_xla`: the hand-written flash kernel
on CUDA for long sequences, `layers.attend` otherwise.

With `tp` (a parallel/mesh.py Mesh whose tp axis has collectives) the
parameters are this rank's tp shards (parallel/mesh.py `shard_params`) and
the forward is tensor-parallel (parallel/tensor.py): attention on the
rank's heads (their q, k, v columns of `qkv`, their rows of `attn_out`),
the FFN on its columns of `ff1` / rows of `ff2`, each block entered by
`copy_to_tp` and left by `reduce_from_tp`; the time MLP on its columns,
gathered before the replicated adaptive norms read it; a split leaf that
no local computation pairs with is gathered before its use."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from covomix_tpu_torch.models import layers as L
from covomix_tpu_torch.models.layers import (adaptive_rmsnorm_init, conv1d_init, embedding_init,  # noqa: F401
                                             linear_init, rmsnorm_init)
from covomix_tpu_torch.ops.flash_attention import attend_flash_or_xla
from covomix_tpu_torch.parallel import tensor as TPX
from covomix_tpu_torch.util import profiling


@dataclasses.dataclass(frozen=True)
class AcousticConfig:
    dim_in: int = 80                 # mel dim (160 for two_two; cond dim for two_one)
    dim: int = 1024                  # transformer width
    depth: int = 8
    dim_head: int = 64
    heads: int = 16
    ff_mult: int = 4
    num_phoneme_tokens: int = 502    # semantic vocab incl. pad/eos; null id == num_phoneme_tokens
    dim_phoneme_emb: int = 1024
    conv_pos_kernel: int = 31
    mode: str = "single"             # 'single' | 'two_two' | 'two_one'
    p_drop_prob: float = 0.3
    frac_lengths_mask: tuple = (0.7, 1.0)

    @property
    def time_hidden_dim(self) -> int:
        return self.dim * 4

    @property
    def mel_dim(self) -> int:
        """dim of x (the flow state) and of the output."""
        return 80 if self.mode == "two_one" else self.dim_in

    @property
    def n_phoneme_streams(self) -> int:
        return 2 if self.mode in ("two_two", "two_one") else 1

    @property
    def embed_in_dim(self) -> int:
        if self.mode == "two_two":
            return self.dim_in * 2 + 2 * self.dim_phoneme_emb
        if self.mode == "two_one":
            return self.dim_in + 80 + 2 * self.dim_phoneme_emb
        return self.dim_in * 2 + self.dim_phoneme_emb


# ---------------------------------------------------------------------------
# init (same names and shapes as the JAX package; numbers from a Generator)


def init(gen: torch.Generator, cfg: AcousticConfig, device=None):
    """Random parameters drawn from `gen` (on gen's device unless `device`)."""
    device = device or gen.device
    d = cfg.dim
    p = {
        "sinu_weights": torch.randn(d // 2, generator=gen, device=device),
        "time_mlp": linear_init(gen, d, cfg.time_hidden_dim, device=device),
        "phoneme_emb": embedding_init(gen, cfg.num_phoneme_tokens + 1, cfg.dim_phoneme_emb, device=device),
        "null_cond": torch.zeros(cfg.dim_in, device=device),
        "to_embed": linear_init(gen, cfg.embed_in_dim, d, device=device),
        "conv_embed": conv1d_init(gen, d, d, cfg.conv_pos_kernel, groups=d, device=device),
        "final_norm": rmsnorm_init(d, device),
        "to_pred": linear_init(gen, d, cfg.mel_dim, bias=False, device=device),
    }
    half = cfg.depth // 2
    layers_p = []
    for i in range(cfg.depth):
        lp = {
            "attn_norm": adaptive_rmsnorm_init(gen, d, cfg.time_hidden_dim, device),
            "qkv": linear_init(gen, d, cfg.heads * cfg.dim_head * 3, bias=False, device=device),
            "attn_out": linear_init(gen, cfg.heads * cfg.dim_head, d, bias=False, device=device),
            "ff_norm": adaptive_rmsnorm_init(gen, d, cfg.time_hidden_dim, device),
            "ff1": linear_init(gen, d, d * cfg.ff_mult, device=device),
            "ff2": linear_init(gen, d * cfg.ff_mult, d, device=device),
        }
        if i >= half:  # U-Net skip combiner on the second half
            lp["skip"] = linear_init(gen, d * 2, d, device=device)
        layers_p.append(lp)
    p["layers"] = layers_p
    return p


# ---------------------------------------------------------------------------
# model


def _time_embedding(params, times, dtype, tp=None, hidden: int = 0):
    """LearnedSinusoidalPosEmb + Linear + SiLU. Under `tp` with the MLP's
    `hidden` columns split, the rank's columns, then gathered."""
    freqs = times[:, None].float() * params["sinu_weights"][None, :] * 2 * math.pi
    fouriered = torch.cat([torch.sin(freqs), torch.cos(freqs)], dim=-1)
    split = TPX.divides(tp, hidden)
    h = F.silu(L.linear(params["time_mlp"], TPX.enter(tp, fouriered.to(dtype), split)))
    return TPX.gather_from_tp(tp, h) if split else h


def layer_core(lp, cfg: AcousticConfig, x, time_emb, key_mask=None, valid_len=None, tp=None, positions=None,
               attend_fn=None):
    """One transformer layer (attention + FFN with adaptive RMSNorm), without
    the U-Net skip combiner: shared by `_transformer`, the pipeline stage
    (parallel/pipeline.py) and the sequence-parallel stack (parallel/ring.py,
    which passes global rotary `positions` and a ring `attend_fn`). A
    `key_mask` sends attention through the masked `layers.attend` path;
    `valid_len` keeps it on the flash kernel. With `attend_fn` the rotary is
    applied here (`layers.rotary_halfsplit`) and attend_fn(q, k, v) attends,
    off the flash route. `tp`: the layer's tp shards, run on the rank's
    heads and FFN columns."""
    inv_freq = L.rotary_freqs(cfg.dim_head, device=x.device)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    inner = cfg.heads * cfg.dim_head
    split = TPX.divides(tp, cfg.heads)
    qkv = lp["qkv"] if split else TPX.full(tp, lp["qkv"], -1, 3 * inner, groups=3)
    attn_out = lp["attn_out"] if split else TPX.full(tp, lp["attn_out"], 0, inner)
    h = L.adaptive_rmsnorm(lp["attn_norm"], x, time_emb)
    q, k, v = torch.chunk(L.linear(qkv, TPX.enter(tp, h, split)), 3, dim=-1)
    heads = q.shape[-1] // cfg.dim_head      # the shard's heads
    q, k, v = (L.split_heads(t, heads) for t in (q, k, v))
    if attend_fn is None:
        attn = attend_flash_or_xla(q, k, v, key_mask=key_mask, valid_len=valid_len, rotary=(positions, inv_freq))
    else:
        attn = attend_fn(L.rotary_halfsplit(positions, inv_freq, q), L.rotary_halfsplit(positions, inv_freq, k), v)
    x = TPX.row_linear(tp, attn_out, L.merge_heads(attn), split) + x
    ff_split = TPX.divides(tp, cfg.dim * cfg.ff_mult)
    h = L.adaptive_rmsnorm(lp["ff_norm"], x, time_emb)
    h = TPX.row_linear(tp, lp["ff2"], L.gelu(L.linear(lp["ff1"], TPX.enter(tp, h, ff_split))), ff_split)
    return h + x


def _transformer(params, cfg: AcousticConfig, x, time_emb, key_mask=None, valid_len=None, tp=None):
    half = cfg.depth // 2
    skips = []
    for i, lp in enumerate(params["layers"]):
        if i < half:
            skips.append(x)
        else:
            x = L.linear(lp["skip"], torch.cat([x, skips.pop()], dim=-1))
        x = layer_core(lp, cfg, x, time_emb, key_mask=key_mask, valid_len=valid_len, tp=tp)
    return L.rmsnorm(params["final_norm"], x)


def static_embed(params, cfg: AcousticConfig, phoneme_ids, cond, *, cond_drop_mask=None,
                 dtype=torch.float32, tp=None):
    """The x-independent part of the input projection:
    to_embed(cat[x, ph, cond]) == x @ W[:mel_dim] + (ph @ W_ph + cond @ W_c + b).
    The sampler computes the bracket once per call. `tp`: a vocab-split
    phoneme table is gathered first."""
    cond = cond.to(dtype)
    if cond_drop_mask is not None:
        null_cond = params["null_cond"].to(dtype)
        cond = torch.where(cond_drop_mask[:, None, None], null_cond[None, None, :], cond)
        nd = cond_drop_mask[:, None, None] if phoneme_ids.dim() == 3 else cond_drop_mask[:, None]
        phoneme_ids = torch.where(nd, torch.full_like(phoneme_ids, cfg.num_phoneme_tokens), phoneme_ids)
    table = {"w": TPX.full_leaf(tp, params["phoneme_emb"]["w"], 0, cfg.num_phoneme_tokens + 1)}
    ph = L.embedding(table, phoneme_ids, dtype)
    if ph.dim() == 4:  # two streams: [B, T, 2, P] -> [B, T, 2P]
        b, t = ph.shape[:2]
        ph = ph.reshape(b, t, 2 * cfg.dim_phoneme_emb)
    w = params["to_embed"]["w"].to(dtype)
    md = cfg.mel_dim
    out = ph @ w[md: md + ph.shape[-1]] + cond @ w[md + ph.shape[-1]:]
    if "b" in params["to_embed"]:
        out = out + params["to_embed"]["b"].to(dtype)
    return out


def embed_inputs(params, cfg: AcousticConfig, x, phoneme_ids, cond, times, *, cond_drop_mask=None, key_mask=None,
                 dtype=torch.float32):
    """Everything in `forward` before the transformer stack: the input
    projection, the depthwise-conv positional embedding and the flow-time
    embedding. Returns (h, time_emb)."""
    x = x.to(dtype)
    emb = static_embed(params, cfg, phoneme_ids, cond, cond_drop_mask=cond_drop_mask, dtype=dtype)
    h = x @ params["to_embed"]["w"].to(dtype)[: cfg.mel_dim] + emb
    conv_in = h if key_mask is None else h * key_mask[..., None].to(dtype)
    conv = L.gelu(L.depthwise_conv1d(params["conv_embed"], conv_in, padding=cfg.conv_pos_kernel // 2))
    return conv + h, _time_embedding(params, times, dtype)


def forward(params, cfg: AcousticConfig, x, phoneme_ids, cond, times, *, cond_drop_mask=None,
            precomputed_embed=None, key_mask=None, valid_len=None, dtype=torch.float32, tp=None):
    """Vector-field prediction [B, T, mel_dim] (f32). `key_mask` [B, T] bool
    (False marks a padded frame) or `valid_len` (int, or one per row: frames
    >= valid_len are padding): the padded frames are zeroed before the
    depthwise conv and masked out of attention. `key_mask` takes precedence
    for the conv, and sends attention through the masked `layers.attend`
    path, as in JAX. `tp`: `params` are this rank's tp shards (module
    docstring); the prediction is every rank's."""
    x = x.to(dtype)
    if precomputed_embed is None:
        precomputed_embed = static_embed(params, cfg, phoneme_ids, cond,
                                         cond_drop_mask=cond_drop_mask, dtype=dtype, tp=tp)
    h = x @ params["to_embed"]["w"].to(dtype)[: cfg.mel_dim] + precomputed_embed
    conv_in = h
    if key_mask is not None:
        conv_in = h * key_mask[..., None].to(dtype)
    elif valid_len is not None:
        vl = torch.as_tensor(valid_len, dtype=torch.int32, device=h.device).reshape(-1)
        frame_keep = torch.arange(h.shape[1], device=h.device)[None, :] < vl[:, None]
        conv_in = h * frame_keep[..., None].to(dtype)
    conv = L.gelu(L.depthwise_conv1d(params["conv_embed"], conv_in, padding=cfg.conv_pos_kernel // 2))
    h = conv + h
    time_emb = _time_embedding(params, times, dtype, tp, cfg.time_hidden_dim)
    h = _transformer(params, cfg, h, time_emb, key_mask=key_mask, valid_len=valid_len, tp=tp)
    return L.linear(params["to_pred"], h).float()


# ---------------------------------------------------------------------------
# training-side mask + loss (OT-CFM, Voicebox eq. 5-6). Random numbers are
# drawn from `gen` on the generator's own device and moved to the data's, so
# one CPU generator gives the same draws to a CPU run and a CUDA run. With
# `mesh` (parallel/mesh.py: `dp`, `rows`) the batch is one rank's rows of a
# global batch: every draw is made for the global batch and the rank keeps
# the rows of its dp index, so the ranks together draw what one device
# would, and the tp ranks of one dp index draw alike.


def _draw(sample, gen, shape, device, mesh=None):
    """sample(shape, generator=, device=) from `gen`; with a mesh, for dp x
    shape[0] rows, keeping this rank's."""
    if mesh is None or not shape:
        return sample(shape, generator=gen, device=gen.device).to(device)
    full = sample((shape[0] * mesh.dp, *shape[1:]), generator=gen, device=gen.device)
    return full[mesh.rows(shape[0])].to(device)


def _rand(gen, shape, device, mesh=None):
    return _draw(torch.rand, gen, shape, device, mesh)


def random_span_mask(gen, batch: int, seq_len: int, frac_lo: float, frac_hi: float, device=None, mesh=None):
    """[B, T] bool: one contiguous True span per row covering a uniform
    fraction in [frac_lo, frac_hi) of the sequence."""
    device = device or gen.device
    frac = _rand(gen, (batch,), device, mesh) * (frac_hi - frac_lo) + frac_lo
    lengths = (frac * seq_len).to(torch.int32)
    start = ((seq_len - lengths) * _rand(gen, (batch,), device, mesh)).to(torch.int32)
    seq = torch.arange(seq_len, device=device)[None, :]
    return (seq >= start[:, None]) & (seq < (start + lengths)[:, None])


def training_mask(gen, cfg: AcousticConfig, batch: int, seq_len: int, device=None, mesh=None):
    """The mask used when the batch carries none: one coin flip for the
    (global) batch between a frac-length span mask and bernoulli(p_drop_prob)."""
    device = device or gen.device
    coin = _rand(gen, (), device) < 0.5
    span = random_span_mask(gen, batch, seq_len, *cfg.frac_lengths_mask, device=device, mesh=mesh)
    bern = _rand(gen, (batch, seq_len), device, mesh) < cfg.p_drop_prob
    return torch.where(coin, span, bern)


def cfm_inputs(cfg: AcousticConfig, gen, x1, cond, mask=None, *, cond_drop_prob: float = 0.0,
               sigma: float = 0.0, mesh=None):
    """All randomness of one OT-CFM training step: (w, times, flow, mask,
    cond_masked, cond_drop_mask). x0 ~ N(0, I), t ~ U[0, 1):
    w = (1 - (1 - sigma) t) x0 + t x1, flow = x1 - (1 - sigma) x0; cond is
    zeroed on the masked region; cond_drop_mask [B] bool (None when
    cond_drop_prob is 0)."""
    b, t, _ = x1.shape
    dev = x1.device
    if mask is None:
        mask = training_mask(gen, cfg, b, t, dev, mesh=mesh)
    x0 = _draw(torch.randn, gen, x1.shape, dev, mesh)
    times = _rand(gen, (b,), dev, mesh)
    tt = times[:, None, None]
    w = (1 - (1 - sigma) * tt) * x0 + tt * x1
    flow = x1 - (1 - sigma) * x0
    cond = cond * (~mask)[:, :, None]
    drop = _rand(gen, (b,), dev, mesh) < cond_drop_prob if cond_drop_prob > 0 else None
    return w, times, flow, mask, cond, drop


def masked_mse(pred, flow, mask):
    """Per-row masked-mean MSE summed over rows."""
    err = torch.mean(torch.square(pred - flow), dim=-1)
    err = torch.where(mask, err, torch.zeros_like(err))
    den = torch.clamp(torch.sum(mask, dim=-1).float(), min=1e-5)
    return torch.sum(torch.sum(err, dim=-1) / den)


def cfm_loss(params, cfg: AcousticConfig, gen, x1, phoneme_ids, cond, mask=None, *,
             cond_drop_prob: float = 0.0, sigma: float = 0.0, dtype=torch.float32, inputs=None, mesh=None):
    """OT-CFM objective: masked-mean MSE between the predicted and the true
    flow over the masked region, averaged over the batch. `inputs`: the
    tuple of `cfm_inputs` drawn beforehand (then `gen` is not used). With
    `mesh` the batch is one rank's equal share of the global batch, so the
    mean over the dp ranks is the global loss; with its tp axis `params`
    are the rank's tp shards and the forward is tensor-parallel."""
    if inputs is None:
        inputs = cfm_inputs(cfg, gen, x1, cond, mask, cond_drop_prob=cond_drop_prob, sigma=sigma, mesh=mesh)
    w, times, flow, mask, cond, drop = inputs
    pred = forward(params, cfg, w, phoneme_ids, cond, times, cond_drop_mask=drop, dtype=dtype,
                   tp=mesh if TPX.active(mesh) else None)
    return masked_mse(pred, flow, mask) / x1.shape[0]


@torch.no_grad()
@profiling.scoped("flow.sample")
def sample(params, cfg: AcousticConfig, generator: Optional[torch.Generator], phoneme_ids, cond, *,
           cond_scale: float = 1.0, step_size: float = 0.0625, key_mask=None, valid_len=None,
           noise=None, dtype=torch.float32, mesh=None):
    """Midpoint ODE integration of the vector field from t=0 to t=1 (16 steps
    at the default step size). y0 ~ N(0, I) from `generator`, or `noise` when
    given. CFG (cond_scale != 1) runs cond + null rows as one 2B batch (and
    doubles `key_mask` / a per-row `valid_len` for it). `key_mask` [B, T] /
    `valid_len` exclude bucket padding as in `forward`. With `mesh` the rows
    are one dp rank's share of a global batch: y0 is drawn for the global
    batch and the rank keeps its rows."""
    n_steps = int(round(1.0 / step_size))
    b, t = cond.shape[0], cond.shape[1]
    dev = cond.device
    if noise is None:
        rows, kept = (b, slice(None)) if mesh is None else (b * mesh.dp, mesh.rows(b))
        y0 = torch.randn((rows, t, cfg.mel_dim), generator=generator, device=dev, dtype=torch.float32)[kept]
    else:
        y0 = noise.to(device=dev, dtype=torch.float32)

    if cond_scale != 1.0:
        ph2 = torch.cat([phoneme_ids, phoneme_ids], dim=0)
        c2 = torch.cat([cond, cond], dim=0)
        drop = torch.cat([torch.zeros(b, dtype=torch.bool, device=dev),
                          torch.ones(b, dtype=torch.bool, device=dev)])
        with profiling.scope("flow.embed"):
            emb2 = static_embed(params, cfg, ph2, c2, cond_drop_mask=drop, dtype=dtype)
        km2 = None if key_mask is None else torch.cat([key_mask, key_mask], dim=0)
        vl2 = valid_len
        if valid_len is not None and torch.as_tensor(valid_len).dim() >= 1:
            vl = torch.as_tensor(valid_len, device=dev)
            vl2 = torch.cat([vl, vl], dim=0)  # cond + null rows

        def field(y, tt):
            times = torch.full((2 * b,), tt, device=dev)
            out = forward(params, cfg, torch.cat([y, y], dim=0), ph2, c2, times, cond_drop_mask=drop,
                          precomputed_embed=emb2, key_mask=km2, valid_len=vl2, dtype=dtype)
            return out[:b] * (1 + cond_scale) - cond_scale * out[b:]
    else:
        with profiling.scope("flow.embed"):
            emb1 = static_embed(params, cfg, phoneme_ids, cond,
                                cond_drop_mask=torch.zeros(b, dtype=torch.bool, device=dev), dtype=dtype)

        def field(y, tt):
            times = torch.full((b,), tt, device=dev)
            return forward(params, cfg, y, phoneme_ids, cond, times, precomputed_embed=emb1,
                           key_mask=key_mask, valid_len=valid_len, dtype=dtype)

    h = 1.0 / n_steps
    y = y0
    for i in range(n_steps):
        with profiling.scope("flow.step"):
            t0 = i * h   # exact in f32 for the power-of-two step sizes used
            k1 = field(y, t0)
            k2 = field(y + 0.5 * h * k1, t0 + 0.5 * h)
            y = y + h * k2
    return y


# Tsitouras 5(4) Runge-Kutta tables (the torchode Tsit5 method)
_TSIT5_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TSIT5_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742, -3.290069515436081, 2.324710524099774),
)
_TSIT5_B = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742, -3.290069515436081, 2.324710524099774, 0.0)
# error-estimate weights btilde = b - bhat
_TSIT5_E = (
    -0.001780011052226, -0.000816434459657, 0.007880878010262, -0.144711007173263,
    0.582357165452555, -0.458082105929187, 1.0 / 66.0,
)


@torch.no_grad()
def sample_adaptive(params, cfg: AcousticConfig, generator: Optional[torch.Generator], phoneme_ids, cond, *,
                    cond_scale: float = 1.0, atol: float = 1e-5, rtol: float = 1e-5, max_steps: int = 64,
                    noise=None, dtype=torch.float32, norms: Optional[list] = None):
    """Adaptive Tsit5 integration of the vector field from t=0 to t=1 with an
    integral step-size controller (h *= clip(0.9 en^-1/5, 0.2, 5)) on the
    embedded 4th-order error estimate, at most `max_steps` attempts. y0 ~
    N(0, I) from `generator`, or `noise`. CFG runs cond + null rows as one
    doubled batch; no valid_len or key mask.

    Time, step and error norm are f32 tensors, as in the JAX while_loop, so
    both end on the same step; each attempt reads accept and t < 1 back in
    one host read (with `norms`, a list, each attempt's error norm is
    appended to it from the same read). The stage derivatives and the
    y / error sums are f32 whatever `dtype`, and the error scale carries a
    rounding-noise floor eps(dtype) h rms_features(k) per frame (eps 0 at
    f32): under bf16 the 5(4) estimate is dominated by the stages' output
    rounding, and without the floor the controller would reject every step
    down to h ~ 0.

    Returns (y [B, T, mel_dim] f32, attempts, rejected ones included)."""
    b, t = cond.shape[0], cond.shape[1]
    dev = cond.device
    if noise is None:
        y = torch.randn((b, t, cfg.mel_dim), generator=generator, device=dev, dtype=torch.float32)
    else:
        y = noise.to(device=dev, dtype=torch.float32)

    if cond_scale != 1.0:
        ph2 = torch.cat([phoneme_ids, phoneme_ids], dim=0)
        c2 = torch.cat([cond, cond], dim=0)
        drop = torch.cat([torch.zeros(b, dtype=torch.bool, device=dev),
                          torch.ones(b, dtype=torch.bool, device=dev)])
        emb2 = static_embed(params, cfg, ph2, c2, cond_drop_mask=drop, dtype=dtype)

        def field(y_s, tt):
            out = forward(params, cfg, torch.cat([y_s, y_s], dim=0), ph2, c2, tt.expand(2 * b), cond_drop_mask=drop,
                          precomputed_embed=emb2, dtype=dtype)
            return out[:b] * (1 + cond_scale) - cond_scale * out[b:]
    else:
        emb1 = static_embed(params, cfg, phoneme_ids, cond,
                            cond_drop_mask=torch.zeros(b, dtype=torch.bool, device=dev), dtype=dtype)

        def field(y_s, tt):
            return forward(params, cfg, y_s, phoneme_ids, cond, tt.expand(b), precomputed_embed=emb1, dtype=dtype)

    n_stages = len(_TSIT5_C)
    noise_eps = torch.finfo(dtype).eps if torch.finfo(dtype).bits < 32 else 0.0
    tt = torch.zeros((), dtype=torch.float32, device=dev)
    h = torch.full((), 0.05, dtype=torch.float32, device=dev)
    steps, more = 0, True
    while more and steps < max_steps:
        h = torch.minimum(h, 1.0 - tt)
        ks = []
        for s in range(n_stages):
            y_s = y
            for j, a in enumerate(_TSIT5_A[s]):
                y_s = y_s + h * a * ks[j]
            ks.append(field(y_s, tt + _TSIT5_C[s] * h).float())
        y_new, err, ksq = y, torch.zeros_like(y), torch.zeros_like(y)
        for s in range(n_stages):
            y_new = y_new + h * _TSIT5_B[s] * ks[s]
            err = err + h * _TSIT5_E[s] * ks[s]
            ksq = ksq + torch.square(ks[s])
        krms = torch.sqrt(torch.mean(ksq / n_stages, dim=-1, keepdim=True))
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y_new)) + noise_eps * h * krms
        en = torch.sqrt(torch.mean(torch.square(err / scale)))
        accept = en <= 1.0
        tt = torch.where(accept, tt + h, tt)
        h = h * torch.clamp(0.9 * torch.pow(torch.clamp(en, min=1e-10), -0.2), 0.2, 5.0)
        en_h, accepted, more = torch.stack([en, accept.float(), (tt < 1.0).float()]).tolist()
        if norms is not None:
            norms.append(en_h)
        if accepted:
            y = y_new
        steps += 1
    return y, steps


@torch.no_grad()
def sample_regression(params, cfg: AcousticConfig, generator: Optional[torch.Generator], phoneme_ids, cond, *,
                      cond_scale: float = 1.0, noise=None, times=None, dtype=torch.float32):
    """One forward of the field at a random time t ~ U[0, 1) per row from
    y0 ~ N(0, I) (drawn from `generator` in that order, or `times` /
    `noise`). CFG runs the null rows as a second forward and combines the
    two as out*(1+s) - s*null."""
    b, t = cond.shape[0], cond.shape[1]
    dev = cond.device
    if times is None:
        times = torch.rand((b,), generator=generator, device=dev)
    if noise is None:
        noise = torch.randn((b, t, cfg.mel_dim), generator=generator, device=dev)
    times, y0 = times.to(device=dev, dtype=torch.float32), noise.to(device=dev, dtype=torch.float32)
    out = forward(params, cfg, y0, phoneme_ids, cond, times,
                  cond_drop_mask=torch.zeros(b, dtype=torch.bool, device=dev), dtype=dtype)
    if cond_scale == 1.0:
        return out
    null = forward(params, cfg, y0, phoneme_ids, cond, times,
                   cond_drop_mask=torch.ones(b, dtype=torch.bool, device=dev), dtype=dtype)
    return out * (1 + cond_scale) - cond_scale * null

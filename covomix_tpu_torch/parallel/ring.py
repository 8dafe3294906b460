"""Sequence parallelism (ring attention) for the acoustic transformer: port
of covomix_tpu/parallel/ring.py.

The time axis of the flow-matching transformer is split over the mesh's
sp axis (one process per device, parallel/mesh.py; rank i holds frames
[i T/sp, (i+1) T/sp) of its dp index's rows), so sequences longer than one
device's activation memory can be trained and sampled.

  * `ring_attention`: non-causal attention with the K / V blocks rotating
    round the sp ring (`collectives.ppermute`, sp - 1 hops a call); the
    partial softmax is combined with the online (max, denominator,
    accumulator) recurrence in f32 with JAX's rounding points (scores in
    f32, p cast to v's dtype before the PV product, acc / max(l, 1e-30)
    cast to q's dtype). Plain PyTorch, as JAX computes it outside any
    Pallas kernel: the flash kernels take no part under sp.
  * `conv1d_halo`: the depthwise positional conv with kernel // 2 halo
    frames from each neighbour; the global edges see zeros, as the
    SAME-padded conv does.
  * `transformer_sp` / `cfm_loss_sp` / `sample_sp`: the stack with global
    rotary positions (rank * T_local + arange) and frame-local U-Net skips,
    the OT-CFM loss (per-row numerators summed over sp) and the midpoint
    sampler with the CFG (cond, null) pair on a local axis of 2.

Every ppermute's backward is the reverse hop, so autograd builds the
reverse ring; every rank builds the same graph (the edge halos are zeroed
with `torch.where`, not skipped). The draws are made for the dp index's
rows at the global T and each rank keeps its frames, so the span mask is
drawn at the global sequence length."""

from __future__ import annotations

from typing import Any, Optional

import torch

from covomix_tpu_torch.models import acoustic as A, layers as L
from covomix_tpu_torch.parallel.collectives import axis_gather, axis_sum, ppermute
from covomix_tpu_torch.parallel.mesh import Mesh, make_mesh


def make_sp_mesh(dp: int, sp: int, device="cuda", devices=None) -> Mesh:
    """JAX's make_sp_mesh: the dp x sp mesh (`mesh.make_mesh(sp=)`)."""
    return make_mesh(dp, device, devices, sp=sp)


def ring_attention(q, k, v, mesh: Mesh):
    """Non-causal attention over a time-split sequence. q / k / v: [B, H,
    T_local, dh], this rank's frames; sp ring steps, the local queries
    attending the K / V block held, then the block moving on."""
    n = mesh.sp
    scale = q.shape[-1] ** -0.5
    b, h, tl, dh = q.shape
    acc = torch.zeros((b, h, tl, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tl, 1), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tl, 1), dtype=torch.float32, device=q.device)
    qf = q.float()
    for step in range(n):
        s = torch.einsum("bhid,bhjd->bhij", qf, k.float()) * scale
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhij,bhjd->bhid", p.to(v.dtype).float(), v.float())
        m = m_new
        if step < n - 1:
            k, v = ppermute(mesh, "sp", [k, v])
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def conv1d_halo(p, x, kernel: int, groups: int, mesh: Mesh):
    """Grouped conv over a time-split [B, T_local, C] activation with
    kernel // 2 halo frames from the ring neighbours (the left halo from
    rank i - 1, the right from i + 1); zeros at the global edges."""
    halo = kernel // 2
    left, = ppermute(mesh, "sp", [x[:, -halo:]], shift=1)
    right, = ppermute(mesh, "sp", [x[:, :halo]], shift=-1)
    edge = {v: torch.tensor(v, device=x.device) for v in (False, True)}
    left = torch.where(edge[mesh.sp_rank == 0], torch.zeros_like(left), left)
    right = torch.where(edge[mesh.sp_rank == mesh.sp - 1], torch.zeros_like(right), right)
    xx = torch.cat([left, x, right], dim=1)
    if groups == xx.shape[-1]:
        return L.depthwise_conv1d(p, xx, padding=0)
    return L.conv1d(p, xx, padding=(0, 0), groups=groups)


def transformer_sp(params, cfg: A.AcousticConfig, x, time_emb, mesh: Mesh):
    """The acoustic transformer stack over time-split activations: global
    rotary positions, ring attention, frame-local U-Net skips."""
    tl = x.shape[1]
    positions = mesh.sp_rank * tl + torch.arange(tl, device=x.device)
    attend = lambda q, k, v: ring_attention(q, k, v, mesh)
    half = cfg.depth // 2
    skips = []
    for i, lp in enumerate(params["layers"]):
        if i < half:
            skips.append(x)
        else:
            x = L.linear(lp["skip"], torch.cat([x, skips.pop()], dim=-1))
        x = A.layer_core(lp, cfg, x, time_emb, positions=positions, attend_fn=attend)
    return L.rmsnorm(params["final_norm"], x)


def _check_frames(cfg: A.AcousticConfig, t: int, sp: int) -> None:
    if t % sp:
        raise ValueError(f"sequence {t} not divisible by sp={sp}")
    if t // sp < cfg.conv_pos_kernel // 2:
        raise ValueError(f"local frames {t // sp} < conv halo {cfg.conv_pos_kernel // 2}: the one-hop halo "
                         f"exchange cannot cover the positional conv")


def _field_input(params, cfg: A.AcousticConfig, y, emb, mesh: Mesh, dtype):
    """The input projection of the local frames and the halo conv."""
    h = y.to(dtype) @ params["to_embed"]["w"].to(dtype)[: cfg.mel_dim] + emb
    return L.gelu(conv1d_halo(params["conv_embed"], h, cfg.conv_pos_kernel, cfg.dim, mesh)) + h


@torch.no_grad()
def sample_sp(params: Any, cfg: A.AcousticConfig, generator: Optional[torch.Generator], phoneme_ids, cond, *,
              mesh: Mesh, cond_scale: float = 1.0, step_size: float = 0.0625, dtype=torch.float32, noise=None):
    """Midpoint ODE sampling (== acoustic.sample for the same y0) with the
    sequence split over sp. phoneme_ids [B, T(, 2)] / cond [B, T, dim_in]:
    this rank's dp rows at the global T (exact length: no key mask). y0 ~
    N(0, I) for the dp rows (drawn as acoustic.sample draws for the global
    batch, the dp rows kept), or `noise` [B, T, mel_dim] of these rows. The
    CFG (cond, null) pair is stacked on a local axis of 2 per row, so the
    combine logits*(1+s) - s*null never crosses ranks. Returns the dp rows'
    [B, T, mel_dim] on every sp rank (the frames gathered)."""
    sp = mesh.sp
    b, t = cond.shape[0], cond.shape[1]
    _check_frames(cfg, t, sp)
    n_steps = int(round(1.0 / step_size))
    h_step = 1.0 / n_steps
    dev = cond.device
    if noise is None:
        y0 = A._draw(torch.randn, generator, (b, t, cfg.mel_dim), dev, mesh)
    else:
        y0 = noise.to(device=dev, dtype=torch.float32)
    nb = 2 if cond_scale != 1.0 else 1
    fr = mesh.frames(t // sp)
    ph2 = torch.repeat_interleave(phoneme_ids[:, fr], nb, dim=0)        # rows (b0 cond, b0 null, b1 cond, ...)
    c2 = torch.repeat_interleave(cond[:, fr], nb, dim=0)
    drop = (torch.arange(nb, device=dev) > 0).repeat(b)
    emb = A.static_embed(params, cfg, ph2, c2, cond_drop_mask=drop, dtype=dtype)
    tl = t // sp

    def field(y, tscalar):
        y2 = torch.repeat_interleave(y, nb, dim=0)
        h = _field_input(params, cfg, y2, emb, mesh, dtype)
        temb = A._time_embedding(params, torch.full((b * nb,), tscalar, device=dev), dtype)
        out = L.linear(params["to_pred"], transformer_sp(params, cfg, h, temb, mesh)).float()
        if nb == 2:
            out = out.reshape(b, 2, tl, cfg.mel_dim)
            return out[:, 0] * (1 + cond_scale) - cond_scale * out[:, 1]
        return out

    y = y0[:, fr]
    for i in range(n_steps):
        t0 = i * h_step
        k1 = field(y, t0)
        k2 = field(y + 0.5 * h_step * k1, t0 + 0.5 * h_step)
        y = y + h_step * k2
    return axis_gather(mesh, "sp", y, 1)


def cfm_loss_sp(params: Any, cfg: A.AcousticConfig, gen: Optional[torch.Generator], x1, phoneme_ids, cond,
                mask=None, *, mesh: Mesh, cond_drop_prob: float = 0.0, sigma: float = 0.0, dtype=torch.float32,
                inputs=None):
    """OT-CFM loss (== acoustic.cfm_loss for the same draws) with the
    sequence split over sp. x1 / phoneme_ids / cond / mask: this rank's dp
    rows at the global T; the draws (`inputs`, or drawn here from `gen`)
    are those rows' at the global T, and each rank keeps its frames. Each
    row's masked squared error is summed over sp (`axis_sum`) and divided
    by its masked frame count (read off the row's whole mask, which every
    rank holds). Returns the mean over the dp rows, as `cfm_loss`."""
    sp = mesh.sp
    b, t, _ = x1.shape
    _check_frames(cfg, t, sp)
    if inputs is None:
        inputs = A.cfm_inputs(cfg, gen, x1, cond, mask, cond_drop_prob=cond_drop_prob, sigma=sigma, mesh=mesh)
    w, times, flow, mask, cond_m, drop = inputs
    if drop is None:
        drop = torch.zeros((b,), dtype=torch.bool, device=x1.device)
    fr = mesh.frames(t // sp)
    emb = A.static_embed(params, cfg, phoneme_ids[:, fr], cond_m[:, fr], cond_drop_mask=drop, dtype=dtype)
    h = _field_input(params, cfg, w[:, fr], emb, mesh, dtype)
    temb = A._time_embedding(params, times, dtype)
    pred = L.linear(params["to_pred"], transformer_sp(params, cfg, h, temb, mesh)).float()
    err = torch.mean(torch.square(pred - flow[:, fr]), dim=-1)
    err = torch.where(mask[:, fr], err, torch.zeros_like(err))
    num = axis_sum(mesh, "sp", torch.sum(err, dim=-1))
    den = torch.clamp(torch.sum(mask, dim=-1).float(), min=1e-5)
    return torch.sum(num / den) / b

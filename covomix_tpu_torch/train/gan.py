"""HiFi-GAN adversarial training (port of covomix_tpu/train/gan.py, the
hifi-gan/train.py loop). Per batch:

  D step: MPD + MSD LSGAN loss on (y, y_hat detached)        (train.py:137-150)
  G step: 45 x L1(mel(y_hat), mel target) + feature matching + adversarial
                                                              (train.py:153-167)

with AdamW(2e-4, betas (0.8, 0.99), weight decay 0.01) for each side and the
learning rate `lr * lr_decay ** (count // steps_per_epoch)` at each
optimizer's count before its update.

The norms are explicit parameter forms, as in the JAX package: weight norm
as (v, g) leaves folded into w = g v / ||v|| on every forward (the generator,
every MPD conv, MSD sub-discriminators 1-2), spectral norm on MSD
sub-discriminator 0 as (w, u, v) leaves whose power-iteration buffers u, v
take exactly one update per step, before the D step; the G step folds with
the updated pair and no second iteration. `torch.nn.utils` norms would
iterate on every training-mode forward. The buffers carry no gradient and
no optimizer sees them; a weight-norm leaf's v is trained.

State is updated in place (parameters, Adam moments, the buffers, the step)
where JAX's jitted step returns a new state. Training runs the generator
unfused (`fuse_tail=False`): the fused stage / tail have no backward."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from covomix_tpu_torch.audio.mel import MelConfig, mel_spectrogram
from covomix_tpu_torch.models import vocoder as V
from covomix_tpu_torch.parallel.train_step import sync_grads
from covomix_tpu_torch.util.misc import tree_map

# ---------------------------------------------------------------------------
# weight norm (v, g) over a parameter tree


def _is_conv_leafdict(d) -> bool:
    return isinstance(d, dict) and "w" in d


def _wn_axes(ndim: int, in_ups: bool) -> tuple:
    """torch weight_norm(dim=0): Conv [K.., I, O] per O (every axis but the
    last); ConvTranspose1d [K, I, O] (torch [I, O, K], dim 0 = I) per I."""
    return (0, 2) if (in_ups and ndim == 3) else tuple(range(ndim - 1))


def wn_split(params: Any, transposed_paths=("ups",)) -> Any:
    """Plain weights -> (v, g): v = w, g = ||w|| over the norm axes (keepdims)."""

    def walk(node, in_ups):
        if _is_conv_leafdict(node):
            w = node["w"]
            g = torch.sqrt(torch.sum(w * w, dim=_wn_axes(w.dim(), in_ups), keepdim=True))
            out = {k: v for k, v in node.items() if k != "w"}
            out["v"] = w
            out["g"] = g
            return out
        if isinstance(node, dict):
            return {k: walk(v, in_ups or k in transposed_paths) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_ups) for v in node]
        return node

    return walk(params, False)


def wn_fold(params: Any, transposed_paths=("ups",)) -> Any:
    """(v, g) -> plain weights, w = g * v / max(||v||, 1e-12) (torch _weight_norm)."""

    def walk(node, in_ups):
        if isinstance(node, dict) and "v" in node and "g" in node:
            v, g = node["v"], node["g"]
            norm = torch.sqrt(torch.sum(torch.square(v), dim=_wn_axes(v.dim(), in_ups), keepdim=True))
            out = {k: val for k, val in node.items() if k not in ("v", "g")}
            out["w"] = g * v / torch.clamp(norm, min=1e-12)
            return out
        if isinstance(node, dict):
            return {k: walk(v, in_ups or k in transposed_paths) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, in_ups) for v in node]
        return node

    return walk(params, False)


# ---------------------------------------------------------------------------
# spectral norm (w, u, v): torch spectral_norm(dim=0) buffers


def _l2n(x, eps: float = 1e-12):
    return x / torch.clamp(torch.linalg.vector_norm(x), min=eps)


def sn_split(params: Any, seed: int = 0) -> Any:
    """Add power-iteration vectors u [O], v [I*K] to every conv leaf, drawn
    in tree order from np.random.RandomState(seed) (the JAX package's draws)
    and normalized in f32."""
    rs = np.random.RandomState(seed)

    def walk(node):
        if _is_conv_leafdict(node):
            w = node["w"]
            o = w.shape[-1]
            u = _l2n(torch.as_tensor(rs.randn(o), dtype=torch.float32))
            v = _l2n(torch.as_tensor(rs.randn(w.numel() // o), dtype=torch.float32))
            return dict(node, u=u.to(w.device), v=v.to(w.device))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


@torch.no_grad()
def sn_power_iter(params: Any) -> Any:
    """One power-iteration update of every (u, v), torch's order (v from the
    previous u, then u from the new v). Returns a new tree; no gradients."""

    def walk(node):
        if isinstance(node, dict) and "u" in node and "w" in node:
            w = node["w"]
            wm = w.reshape(-1, w.shape[-1]).T          # [O, I*K]
            v = _l2n(wm.T @ node["u"])
            return dict(node, u=_l2n(wm @ v), v=v)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def sn_fold(params: Any) -> Any:
    """w -> w / sigma, sigma = u^T W v from the stored buffers (constants to
    the gradient; it flows through W in the numerator and in sigma)."""

    def walk(node):
        if isinstance(node, dict) and "u" in node and "w" in node:
            w = node["w"]
            wm = w.reshape(-1, w.shape[-1]).T
            sigma = node["u"].detach() @ (wm @ node["v"].detach())
            out = {k: x for k, x in node.items() if k not in ("u", "v")}
            out["w"] = w / sigma
            return out
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def split_discriminators(mpd: Any, msd: Any):
    """The reference norm layout (hifi-gan/models.py:132/:194/:223): weight
    norm on every MPD conv and on MSD sub-discriminators 1-2, spectral norm
    on MSD sub-discriminator 0."""
    mpd = wn_split(mpd, transposed_paths=())
    ds = list(msd["discriminators"])
    ds[0] = sn_split(ds[0])
    ds[1] = wn_split(ds[1], transposed_paths=())
    ds[2] = wn_split(ds[2], transposed_paths=())
    return mpd, {"discriminators": ds}


def fold_discriminators(mpd: Any, msd: Any):
    ds = list(msd["discriminators"])
    ds[0] = sn_fold(ds[0])
    ds[1] = wn_fold(ds[1], transposed_paths=())
    ds[2] = wn_fold(ds[2], transposed_paths=())
    return wn_fold(mpd, transposed_paths=()), {"discriminators": ds}


# ---------------------------------------------------------------------------
# GAN trainer


@dataclasses.dataclass(frozen=True)
class GanConfig:
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999           # per epoch (hifi-gan/train.py:83-84)
    steps_per_epoch: int = 1000
    segment_size: int = 8032
    mel_loss_weight: float = 45.0
    weight_norm: bool = True


@dataclasses.dataclass
class GanState:
    gen_params: Any                # (v, g) tree under weight norm; leaves require grad
    mpd_params: Any
    msd_params: Any                # MSD[0] leaves carry the spectral buffers u, v (no grad)
    opt_g: torch.optim.AdamW       # over trainable_leaves(gen_params)
    opt_d: torch.optim.AdamW       # over trainable_leaves({"mpd": ..., "msd": ...})
    step: int = 0

    @property
    def d_params(self) -> dict:
        return {"mpd": self.mpd_params, "msd": self.msd_params}


def trainable_leaves(tree: Any, prefix: str = "") -> list:
    """[(path, leaf)] in named_leaves order, without the spectral buffers
    (u, and v where the leaf has u; a weight-norm leaf's v is trained)."""
    if isinstance(tree, dict):
        has_u = "u" in tree
        return [item for k, x in tree.items() if not (k == "u" or (has_u and k == "v"))
                for item in trainable_leaves(x, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree) for item in trainable_leaves(x, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _make_opt(leaves, cfg: GanConfig) -> torch.optim.AdamW:
    # torch.optim.AdamW's default weight decay, 0.01: the reference builds
    # its AdamW without the argument (hifi-gan/train.py:66-69)
    return torch.optim.AdamW(leaves, lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8,
                             weight_decay=0.01)


def make_gan_state(gen_params, mpd_params, msd_params, cfg: GanConfig, step: int = 0) -> GanState:
    """Take the trees as the trained parameters: their trainable leaves
    require grad and get one AdamW per side, with fresh moments."""
    d_params = {"mpd": mpd_params, "msd": msd_params}
    g_leaves = [p for _, p in trainable_leaves(gen_params)]
    d_leaves = [p for _, p in trainable_leaves(d_params)]
    for p in g_leaves + d_leaves:
        p.requires_grad_(True)
    return GanState(gen_params, mpd_params, msd_params, _make_opt(g_leaves, cfg), _make_opt(d_leaves, cfg), step)


def init_gan_state(gen: torch.Generator, voc_cfg: V.VocoderConfig, cfg: GanConfig, device=None) -> GanState:
    """Random generator, MPD and MSD drawn from `gen` (on its device), in the
    reference's norm layout when cfg.weight_norm, then moved to `device`."""
    g_p, mpd, msd = V.init_generator(gen, voc_cfg), V.init_mpd(gen), V.init_msd(gen)
    if cfg.weight_norm:
        g_p = wn_split(g_p)
        mpd, msd = split_discriminators(mpd, msd)
    if device is not None:
        g_p, mpd, msd = (tree_map(lambda t: t.to(device), tree) for tree in (g_p, mpd, msd))
    return make_gan_state(g_p, mpd, msd, cfg)


def opt_count(opt: torch.optim.Optimizer) -> int:
    """The optimizer's update count (every leaf's Adam `step` is the same)."""
    st = opt.state.get(opt.param_groups[0]["params"][0])
    return int(st["step"]) if st else 0


def learning_rate(cfg: GanConfig, count: int) -> float:
    """ExponentialLR per epoch, at the optimizer's count before the update."""
    return cfg.learning_rate * cfg.lr_decay ** (count // cfg.steps_per_epoch)


def _update(opt: torch.optim.AdamW, grads, cfg: GanConfig) -> None:
    (group,) = opt.param_groups
    group["lr"] = learning_rate(cfg, opt_count(opt))
    for p, g in zip(group["params"], grads, strict=True):
        p.grad = g
    opt.step()


class GanStep:
    """step(state, batch) -> metrics (0-dim tensors on the batch's device),
    updating `state` in place: the spectral power iteration, the D step,
    the G step, the counters.

    batch: {'audio': [B, segment] target waveform} and optionally {'mel':
    [B, T, num_mels]} (the fine-tuning input mel, hifi-gan/meldataset.py:
    142-160) and {'mel_loss_target': [B, T, num_mels]}; what is absent is
    computed here from `audio`. After a step each trained leaf's `.grad`
    holds the gradient its optimizer took. `d_step` and `g_step` are the two
    halves, for timing them apart.

    `mesh` (parallel/mesh.py): the batch is this rank's equal share of the
    global batch; D's gradients and losses are averaged over the ranks
    before D's update and G's before G's (one all-reduce each), as the JAX
    step's two value_and_grads are over its 'dp' axis. The losses are
    element means, so the ranks' mean is the global loss, and the power
    iteration runs on weights that are the same on every rank."""

    def __init__(self, voc_cfg: V.VocoderConfig, mel_cfg: MelConfig, mel_loss_cfg: MelConfig, cfg: GanConfig,
                 dtype=torch.float32, mesh=None):
        self.voc_cfg, self.mel_cfg, self.mel_loss_cfg, self.cfg, self.dtype, self.mesh = (
            voc_cfg, mel_cfg, mel_loss_cfg, cfg, dtype, mesh)

    def _sync(self, grads, *losses):
        """The ranks' mean of the gradients (in place) and of the losses."""
        return losses if self.mesh is None else sync_grads(self.mesh, grads, *losses)

    def d_fold(self, d_params):
        if not self.cfg.weight_norm:
            return d_params
        mpd_f, msd_f = fold_discriminators(d_params["mpd"], d_params["msd"])
        return {"mpd": mpd_f, "msd": msd_f}

    def gen_fwd(self, gen_params, mel, out_len: int):
        p = wn_fold(gen_params) if self.cfg.weight_norm else gen_params
        y = V.generator(p, self.voc_cfg, mel, dtype=self.dtype, fuse_tail=False)
        # T frames -> 160 T + 32 samples: segment 8032 = 160 * 50 + 32 lines
        # up exactly (config_covomix.json); trim / pad for other segments
        if y.shape[1] > out_len:
            y = y[:, :out_len]
        elif y.shape[1] < out_len:
            y = torch.nn.functional.pad(y, (0, out_len - y.shape[1]))
        return y

    @torch.no_grad()
    def inputs(self, batch):
        """(y, input mel [B, T, M], mel-L1 target [B, T, M])."""
        y = batch["audio"]
        mel = batch["mel"] if "mel" in batch else mel_spectrogram(y, self.mel_cfg).transpose(1, 2)
        if "mel_loss_target" in batch:
            target = batch["mel_loss_target"]
        else:
            target = mel_spectrogram(y, self.mel_loss_cfg).transpose(1, 2)
        return y, mel, target

    def d_step(self, state: GanState, y, mel):
        """Power iteration, then the discriminators' loss on (y, y_hat
        detached) and their AdamW update. Returns (loss, mpd part, msd part)."""
        with torch.no_grad():
            y_hat = self.gen_fwd(state.gen_params, mel, y.shape[1])
        if self.cfg.weight_norm:
            ds = list(state.msd_params["discriminators"])
            ds[0] = sn_power_iter(ds[0])
            state.msd_params = {"discriminators": ds}
        dp = self.d_fold(state.d_params)
        rs, gs, _, _ = V.mpd(dp["mpd"], y, y_hat)
        loss_f = V.discriminator_loss(rs, gs)
        rs2, gs2, _, _ = V.msd(dp["msd"], y, y_hat)
        loss_s = V.discriminator_loss(rs2, gs2)
        loss = loss_f + loss_s
        leaves = [p for _, p in trainable_leaves(state.d_params)]
        grads = torch.autograd.grad(loss, leaves)
        losses = self._sync(grads, loss.detach(), loss_f.detach(), loss_s.detach())
        _update(state.opt_d, grads, self.cfg)
        return tuple(losses)

    def g_step(self, state: GanState, y, mel, target):
        """The generator's loss against the updated discriminators (folded
        as constants: the gradient reaches the generator's leaves only) and
        its AdamW update. Returns (loss, mel L1 x weight, feature, adversarial)."""
        with torch.no_grad():
            dp = self.d_fold(state.d_params)
        y_hat = self.gen_fwd(state.gen_params, mel, y.shape[1])
        mel_hat = mel_spectrogram(y_hat, self.mel_loss_cfg)
        loss_mel = torch.mean(torch.abs(mel_hat - target.transpose(1, 2))) * self.cfg.mel_loss_weight
        _, gs, fr, fg = V.mpd(dp["mpd"], y, y_hat)
        _, gs2, fr2, fg2 = V.msd(dp["msd"], y, y_hat)
        loss_fm = V.feature_loss(fr, fg) + V.feature_loss(fr2, fg2)
        loss_adv = V.generator_adv_loss(gs) + V.generator_adv_loss(gs2)
        loss = loss_adv + loss_fm + loss_mel
        leaves = [p for _, p in trainable_leaves(state.gen_params)]
        grads = torch.autograd.grad(loss, leaves)
        losses = self._sync(grads, loss.detach(), loss_mel.detach(), loss_fm.detach(), loss_adv.detach())
        _update(state.opt_g, grads, self.cfg)
        return tuple(losses)

    def __call__(self, state: GanState, batch) -> dict:
        y, mel, target = self.inputs(batch)
        d_loss, _, _ = self.d_step(state, y, mel)
        g_loss, l_mel, l_fm, l_adv = self.g_step(state, y, mel, target)
        state.step += 1
        return {"loss_disc": d_loss, "loss_gen": g_loss, "mel_error": l_mel / self.cfg.mel_loss_weight,
                "loss_fm": l_fm, "loss_adv": l_adv}


def make_gan_step(voc_cfg: V.VocoderConfig, mel_cfg: MelConfig, mel_loss_cfg: MelConfig, cfg: GanConfig,
                  dtype=torch.float32, mesh=None) -> GanStep:
    """The JAX package's make_gan_step; `mesh` (parallel/mesh.py) for its
    dp mesh: the batch is the rank's rows, gradients averaged over ranks."""
    return GanStep(voc_cfg, mel_cfg, mel_loss_cfg, cfg, dtype, mesh)


@torch.no_grad()
def export_generator(state: GanState, cfg: GanConfig):
    """Inference weights: weight norm folded (remove_weight_norm at load,
    covomix/vocoder/models.py:118-125), detached."""
    gen = wn_fold(state.gen_params) if cfg.weight_norm else state.gen_params
    return tree_map(lambda t: t.detach().clone(), gen)

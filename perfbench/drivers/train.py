"""Recipe training: `train.loop.make_multi_step(loss, TrainConfig(lr), k)`,
the step that `--steps_per_dispatch k` dispatches (on the card the k steps
are one captured CUDA graph), a closed loop of dispatches.

Traffic (the workload's `traffic`): `model` "acoustic" (the loss
`acoustic_loss_fn(cfg, cond_drop_prob, bf16)` on batches {x: [B, T, cond +
mel] mels, phonemes, mask: one contiguous span of a `mask_frac` share at a
random start}) or "t2s" (`t2s_loss_fn(cfg, bf16)` on {text_ids: [B, S],
semantic_ids: [B, T(, 2)]}); each dispatch a fresh stack of k batches drawn
on the card from the seed. The loss is read back on the host after each
dispatch.

Set-up builds the one training state (the seeded weights, Adam, EMA) and
drives it through its first dispatch (the capture and its first replay);
that same object trains in the window. Check (after the window): the
reference follows the set-up's dispatch and the window's first (a replay
with its batch, rates and generator state refreshed, the state written
back) from the same weights, batches and random draws (the generator's
state before the first dispatch; the objective's draws x0, t and the
condition drop in its order), f32 with Adam by formula: each of the 2 k
steps' loss (the widest relative gap), and after them, leaf by leaf, the
norm of Adam's first moment (the gradients as the optimizer took them) and
the norm of the parameters' change, each as the widest gap between the
program's norm and the reference's over the reference's norm of that leaf
or of the median leaf, whichever is larger. Leaves whose reference moment
is under a thousandth of the median leaf's (a gradient nought to rounding) are left out of the two leaf numbers."""

from __future__ import annotations

import math
import sys

import torch

from perfbench.lib import flops as FL
from perfbench.lib import models
from perfbench.lib import weights
from perfbench.reference import spec
from perfbench.reference import train as RTR
from perfbench.reference.nn import Precision


class Driver:
    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.wl["traffic"]
        self.model = self.tr["model"]
        self.tapped = None      # the window's first dispatch's leaf norms, kept by `_tap`

    # -- inputs ---------------------------------------------------------------

    def _spec(self):
        c = self.ctx.cfg
        return spec.acoustic(c["acoustic"]) if self.model == "acoustic" else spec.t2s(c["t2s"])

    def _weights(self):
        """The trained model's weights, drawn from the run's seed (the same
        draw as the serving cells' trees), as separate tensors."""
        g = self.ctx.generator("weights")
        tree = weights.make(self._spec(), g, self.ctx.device)
        return RTR.tree_like([t.clone() for t in RTR.leaves_of(tree)], tree)

    def _stack(self, gen):
        """One dispatch's k batches, drawn on the card from `gen`."""
        tr, c, dev, k = self.tr, self.ctx.cfg, self.ctx.device, self.tr["k"]
        b = tr["batch"]
        if self.model == "t2s":
            shape = (k, b, tr["targets"], 2) if c["t2s"]["two_output"] else (k, b, tr["targets"])
            return {"text_ids": torch.randint(1, c["t2s"]["num_text_tokens"] - 6, (k, b, tr["text_ids"]),
                                              generator=gen, device=dev),
                    "semantic_ids": torch.randint(0, c["t2s"]["num_semantic_tokens"], shape, generator=gen,
                                                  device=dev)}
        a, t = c["acoustic"], tr["frames"]
        width = a["dim_in"] + 80 if a["mode"] == "two_one" else a["dim_in"]
        streams = 2 if a["mode"] in ("two_one", "two_two") else 1
        lo, hi = tr["mask_frac"]
        frac = torch.rand((k, b), generator=gen, device=dev) * (hi - lo) + lo
        length = (frac * t).long()
        start = (torch.rand((k, b), generator=gen, device=dev) * (t - length + 1)).long()
        pos = torch.arange(t, device=dev)
        ph_shape = (k, b, t, streams) if streams == 2 else (k, b, t)
        return {"x": torch.rand((k, b, t, width), generator=gen, device=dev) * 13.5 - 11.5,
                "phonemes": torch.randint(0, a["num_phoneme_tokens"] - 2, ph_shape, generator=gen,
                                          device=dev, dtype=torch.int32),
                "mask": (pos >= start[..., None]) & (pos < (start + length)[..., None])}

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        from covomix_tpu_torch.train import loop

        ctx, tr = self.ctx, self.tr
        models.install_spans(ctx)
        tcfg, acfg, _ = models.program_configs(ctx.cfg)
        dtype = models.DTYPES[ctx.cfg["dtype"]]
        if self.model == "acoustic":
            loss_fn = loop.acoustic_loss_fn(acfg, cond_drop_prob=tr["cond_drop_prob"], dtype=dtype)
        else:
            loss_fn = loop.t2s_loss_fn(tcfg, dtype=dtype)
        params = self._weights()
        self.state = loop.init_train_state(params, loop.TrainConfig(lr=tr["lr"]))
        self.step_fn = loop.make_multi_step(loss_fn, loop.TrainConfig(lr=tr["lr"]), tr["k"])
        self.data, self.gen = ctx.generator("data"), ctx.generator("train")
        # the first dispatch; the check follows it and the window's first
        self.leaves = RTR.leaves_of(params)
        self.before = [p.detach().float().clone() for p in self.leaves]
        self.gen_state = self.gen.get_state()
        metrics = self.step_fn(self.state, self._stack(self.data), self.gen)
        self.losses = metrics["loss"].float().cpu().tolist()
        self._leaf_norms([b.clone() for b in self.before])    # the tap's kernels loaded before the window
        ctx.sync()

    def _leaf_norms(self, before):
        """By leaf, the norms of Adam's first moment and of `before` - now
        (subtracted in place): three multi-tensor operations, left on the
        device."""
        opt, zero = self.state.optimizer.state, torch.zeros((), device=self.ctx.device)
        with torch.no_grad():
            torch._foreach_sub_(before, self.leaves)
            moments = [opt.get(p, {}).get("exp_avg", zero) for p in self.leaves]    # none: the step never ran
            return torch._foreach_norm(moments), torch._foreach_norm(before)

    def _tap(self, metrics):
        """After the window's first dispatch: its losses, and its leaf norms
        against the seeded weights, read by `check` after the window."""
        self.tapped = self._leaf_norms(self.before)
        self.losses += metrics["loss"].float().cpu().tolist()
        self.before = None

    # -- the window -----------------------------------------------------------

    def step(self, i):
        tr, c, k = self.tr, self.ctx.cfg, self.tr["k"]
        metrics = self.step_fn(self.state, self._stack(self.data), self.gen)
        if i == 0:
            self._tap(metrics)
        losses = metrics["loss"].float().cpu()
        failed = int((~torch.isfinite(losses)).sum())
        b = tr["batch"]
        if self.model == "acoustic":
            a, t = c["acoustic"], tr["frames"]
            flops = k * FL.acoustic_train_flops(a, b, t)
            rows, heads, length, depth, causal = b, a["heads"], t, a["depth"], False
            dh = a["dim_head"]
        else:
            t2 = c["t2s"]
            t = tr["targets"]
            flops = k * FL.t2s_train_flops(t2, b, tr["text_ids"], t)
            rows, heads, length, depth, causal = b, t2["heads"], t + 2, t2["target_depth"], True
            dh = t2["dim_head"]
        return {"requests": k, "failed": failed, "frames": k * b * t, "flops": flops,
                "flash_bwd": [(f, by, k * depth) for f, by in FL.flash_backward(rows, heads, length, dh, causal)]}

    def counters(self):
        from covomix_tpu_torch.ops import flash_attention as FA
        s = self.step_fn
        return {"dispatches": len(self.ctx.records), "captures": getattr(s, "captures", None),
                "replays": getattr(s, "replays", None), "replayed_flash": dict(getattr(s, "replayed", {})),
                "eager_flash_dq": FA.KERNEL.dq_launches, "checked_losses": self.losses}

    def release(self):
        self.state = self.step_fn = None
        self.leaves = self.before = None
        models.unwrap_all(self.ctx)
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def check(self, control: bool = False):
        ctx, tr = self.ctx, self.tr
        limits = ctx.wl["limits"]
        if self.tapped is None and not control:     # the window's first dispatch failed: nothing to compare
            return [(name, None, limits[name]) for name in ("loss_rel_err", "adam_m_leaf_err", "param_change_leaf_err")]
        c = ctx.cfg["acoustic"] if self.model == "acoustic" else ctx.cfg["t2s"]
        params = self._weights()
        data = ctx.generator("data")
        stacks = [self._stack(data) for _ in range(2)]      # the set-up's dispatch, the window's first
        batches = [{name: v[i] for name, v in stack.items()} for stack in stacks for i in range(tr["k"])]
        draws = [None] * len(batches)
        if self.model == "acoustic":
            gen = torch.Generator(device=ctx.device)
            gen.set_state(self.gen_state)
            draws = [RTR.cfm_draws(gen, tr["batch"], tr["frames"], 80 if c["mode"] == "two_one" else c["dim_in"],
                                   tr["cond_drop_prob"]) for _ in batches]
        loss_fn = RTR.cfm_loss if self.model == "acoustic" else RTR.t2s_loss
        fn = lambda p, batch, draw, q: loss_fn(p, c, batch, draw, q)
        ref_losses, ref_m, ref_p = RTR.adam_steps(params, fn, batches, draws, tr["lr"])
        p0 = RTR.leaves_of(params)
        ref_mn = [float(torch.linalg.vector_norm(m)) for m in ref_m]
        ref_dp = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(ref_p, p0)]
        del ref_m, ref_p
        if control:
            got_losses, got_m, got_p = RTR.adam_steps(params, fn, batches, draws, tr["lr"], q=Precision("fp8"))
            got_mn = [float(torch.linalg.vector_norm(m)) for m in got_m]
            got_dp = [float(torch.linalg.vector_norm(a - b)) for a, b in zip(got_p, p0)]
        else:
            got_mn, got_dp = (torch.stack(n).float().cpu().tolist() for n in self.tapped)
            got_losses = self.losses
        loss_err = max(abs(g - r) / abs(r) if math.isfinite(g) else math.inf for g, r in zip(got_losses, ref_losses))
        names = RTR.names_of(params)
        m_gap, dp_gap = leaf_gap(got_mn, ref_mn, ref_mn, names), leaf_gap(got_dp, ref_dp, ref_mn, names)
        return [("loss_rel_err", loss_err, limits["loss_rel_err"]),
                ("adam_m_leaf_err", m_gap, limits["adam_m_leaf_err"]),
                ("param_change_leaf_err", dp_gap, limits["param_change_leaf_err"])]


def leaf_gap(got, ref, ref_moment, names):
    """max over leaves of |got - ref| / max(ref, the median leaf's ref),
    leaving out leaves whose reference moment is under a thousandth of the
    median leaf's; the three widest leaves go to standard error."""
    med_m = sorted(ref_moment)[len(ref_moment) // 2]
    kept = [i for i, m in enumerate(ref_moment) if m >= 1e-3 * med_m]
    med = sorted(ref[i] for i in kept)[len(kept) // 2]
    gaps = sorted(((abs(got[i] - ref[i]) / max(ref[i], med, 1e-30) if math.isfinite(got[i]) else math.inf, i)
                   for i in kept), reverse=True)
    print("# widest leaves: " + "; ".join(f"{names[i]} {g:.4g} (got {got[i]:.4g}, ref {ref[i]:.4g})"
                                          for g, i in gaps[:3]), file=sys.stderr, flush=True)
    return gaps[0][0] if gaps else 0.0

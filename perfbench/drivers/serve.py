"""Batched dialogue serving: `serving.BatchedPipeline.__call__` as
`serve_batch` drives it, a closed loop of whole calls.

Traffic (the workload's `traffic`): each call takes a fresh batch of
`batch` dialogues, `text_ids` random text ids each and two prompts of
`prompt_frames` frames (semantic tokens and 160-d mels), made on the host
from the seed (a pool of `pool` batches, cycled) and passed as numpy; the
flow's y0 is drawn on the device from the seed and passed as `noise`. Every
`greedy_every`-th call (the first included) decodes greedily
(`greedy_top_k_thres` keeps one token), the others with the serving default
`top_k_thres`. The wavs are copied to the host.

Check: the decoded tokens of every row of the greedy calls against the
reference's teacher-forced logits (the widest gap below the best non-EOS
logit, EOS being masked for the whole decode); for rows drawn from the seed
among the calls of the window (`check_rows` at most, one a call) the flow's
mel of the row against the reference ODE on the reference's own packing of
the served tokens with the same y0 (relative L2), and the row's wav against
the reference generator on the program's mel (relative L2)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import flops as FL
from perfbench.lib import models
from perfbench.reference import acoustic as RA
from perfbench.reference import sampling as RS
from perfbench.reference import t2s as RT
from perfbench.reference import vocoder as RV
from perfbench.reference.nn import Precision

FRAME_S = 0.02
FLOW_EVALS = 32
SILENCE, CAP = 157, 501


class Driver:
    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.wl["traffic"]
        self.kept = {}       # step -> what the check compares

    # -- set-up ---------------------------------------------------------------

    def _batch(self, rng):
        tr, dim_in = self.tr, self.ctx.cfg["acoustic"]["dim_in"]
        b, p = tr["batch"], tr["prompt_frames"]
        ids = rng.integers(1, self.ctx.cfg["t2s"]["num_text_tokens"] - 6, (b, tr["text_ids"]), dtype=np.int32)
        tok = rng.integers(0, 500, (b, p, 2), dtype=np.int32)
        mel = rng.uniform(-11.5, 2.0, (b, p, dim_in)).astype(np.float32)
        return ids, tok, mel, np.full((b,), p, np.int32)

    def setup(self):
        from covomix_tpu_torch.serving import BatchedPipeline

        ctx, tr = self.ctx, self.tr
        models.install_spans(ctx)
        models.wrap(ctx, "covomix_tpu_torch.models.acoustic:sample", self._tap_sample)
        self.tcfg, self.acfg, self.vcfg = models.program_configs(ctx.cfg)
        w = models.make_weights(ctx)
        dtype = models.DTYPES[ctx.cfg["dtype"]]
        common = dict(decode_len=tr["decode_len"], cond_scale=tr["cond_scale"], dtype=dtype,
                      min_length=tr["decode_len"], device=ctx.device)
        self.pipes = {k: BatchedPipeline(w["t2s"], self.tcfg, w["acoustic"], self.acfg, w["vocoder"], self.vcfg,
                                         top_k_thres=tr[k], **common)
                      for k in ("top_k_thres", "greedy_top_k_thres")}
        rng = ctx.rng("inputs")
        self.pool = [self._batch(rng) for _ in range(tr["pool"])]
        self.gen, self.noise_gen = ctx.generator("sampling"), ctx.generator("noise")
        self.pick = ctx.rng("check")
        warm = self._batch(ctx.rng("warm"))
        for pipe in self.pipes.values():       # every shape of the window: the decode graph of each
            self._call(pipe, warm, keep=None)
        ctx.sync()

    def _tap_sample(self, fn):
        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self._keep_row is not None:
                self._kept_mel = out[self._keep_row].clone()
            return out
        return tapped

    def _call(self, pipe, batch, keep):
        tr = self.tr
        ids, tok, mel, plens = batch
        total = tr["prompt_frames"] + tr["decode_len"]
        noise = torch.randn((tr["batch"], total, 80), generator=self.noise_gen, device=self.ctx.device)
        self._keep_row, self._kept_mel = keep, None
        wav, res = pipe(self.gen, ids, tok, mel, prompt_lens=plens, noise=noise)
        wav = wav.cpu().numpy()
        lengths = torch.minimum(res.lengths, res.lengths2).cpu().numpy()
        return wav, res, lengths, noise

    # -- the window -----------------------------------------------------------

    def step(self, i):
        tr = self.tr
        greedy = i % tr["greedy_every"] == 0
        batch = self.pool[i % len(self.pool)]
        row = int(self.pick.integers(0, tr["batch"]))
        wav, res, lengths, noise = self._call(self.pipes["greedy_top_k_thres" if greedy else "top_k_thres"],
                                              batch, row)
        failed = int(np.sum(~np.isfinite(wav).all(axis=1)) + np.sum(lengths <= 0))
        rows = slice(None) if greedy else slice(row, row + 1)
        self.kept[i] = {"batch": i % len(self.pool), "row": row, "greedy": greedy, "lens": lengths[rows].copy(),
                        "tok1": res.tokens[rows].cpu(), "tok2": res.tokens2[rows].cpu(),
                        "noise": noise[row].cpu(), "mel": self._kept_mel.cpu(), "wav": wav[row].copy()}
        b, p, t = tr["batch"], tr["prompt_frames"], tr["prompt_frames"] + tr["decode_len"]
        valid = [p + int(g) for g in lengths] * 2
        c = self.ctx.cfg
        flops = (FL.t2s_forward_flops(c["t2s"], b, tr["text_ids"], res.num_steps)
                 + FLOW_EVALS * FL.flow_field_flops(c["acoustic"], 2 * b, t, valid_len=valid)
                 + FL.vocoder_flops(c["vocoder"], b, tr["decode_len"]))
        ac = c["acoustic"]
        flash = FL.flash_forward(2 * b, ac["heads"], t, ac["dim_head"], valid_len=valid)
        return {"requests": b, "failed": failed, "audio_s": float(lengths.sum()) * FRAME_S, "flops": flops,
                "decode_steps": res.num_steps,
                "flash_fwd": [(flash[0], flash[1], FLOW_EVALS * ac["depth"])]}

    def counters(self):
        from covomix_tpu_torch.ops import flash_attention as FA
        k = FA.KERNEL
        return {"flash_fwd_launches": k.launches, "rotary_launches": k.rotary_launches,
                "calls": len(self.ctx.records),
                "decode_steps": [r.get("decode_steps") for r in self.ctx.records]}

    def release(self):
        self.pipes = None
        models.unwrap_all(self.ctx)
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------

    def check(self, control: bool = False):
        """[(name, value, limit)]: the program's readings against the f32
        reference, or with `control` the fp8 reference's."""
        ctx, tr = self.ctx, self.tr
        c, dev = ctx.cfg, ctx.device
        limits = ctx.wl["limits"]
        w = models.make_weights(ctx)           # drawn again: the reference shares no tensor with the program
        low = Precision("fp8")
        steps = sorted(self.kept)
        not_eos = torch.arange(c["t2s"]["num_semantic_tokens"] + 1, device=dev) != c["t2s"]["num_semantic_tokens"]
        gaps, mel_err, wav_err = [], [], []
        for s in steps:
            k = self.kept[s]
            if not k["greedy"]:
                continue
            ids = torch.as_tensor(self.pool[k["batch"]][0], device=dev)
            for r0 in range(0, len(ids), tr["check_batch"]):
                sl = slice(r0, r0 + tr["check_batch"])
                t1, t2 = k["tok1"][sl].to(dev), k["tok2"][sl].to(dev)
                ref1, ref2 = RT.logits(w["t2s"], c["t2s"], ids[sl], t1, t2)
                if control:
                    picks = [RS.best(lg, not_eos) for lg in RT.logits(w["t2s"], c["t2s"], ids[sl], t1, t2, q=low)]
                else:
                    picks = [t1, t2]
                valid = torch.arange(t1.shape[1], device=dev)[None, :] < torch.as_tensor(k["lens"][sl], device=dev)[:, None]
                gaps.append(max(RS.gap(ref1, not_eos, picks[0], valid), RS.gap(ref2, not_eos, picks[1], valid)))
                del ref1, ref2
        order = self.pick.permutation(len(steps))
        chosen = [steps[j] for j in order[:tr["check_rows"]]]
        for s in chosen:
            k = self.kept[s]
            ids, tok, mel, plens = self.pool[k["batch"]]
            r, p = k["row"], tr["prompt_frames"]
            at = r if k["greedy"] else 0
            n = int(k["lens"][at])
            t1, t2 = k["tok1"][at, :n].to(dev), k["tok2"][at, :n].to(dev)
            # the reference's own packing: [prompt ‖ tokens (<= 501) ‖ silence], cond [prompt mel ‖ 0]
            total = p + tr["decode_len"]
            ph = torch.full((total, 2), SILENCE, dtype=torch.long, device=dev)
            ph[:p] = torch.as_tensor(tok[r], device=dev).long()
            ph[p:p + n, 0], ph[p:p + n, 1] = t1.long().clamp(0, CAP), t2.long().clamp(0, CAP)
            cond = torch.zeros((total, mel.shape[-1]), device=dev)
            cond[:p] = torch.as_tensor(mel[r], device=dev)
            valid = torch.tensor([p + n], device=dev)
            y0 = k["noise"].to(dev)[None]
            ref_mel = RA.sample(w["acoustic"], c["acoustic"], y0, ph[None], cond[None], valid, tr["cond_scale"])[0]
            got_mel = (RA.sample(w["acoustic"], c["acoustic"], y0, ph[None], cond[None], valid, tr["cond_scale"],
                                 q=low)[0] if control else k["mel"].to(dev))
            mel_err.append(_rel(got_mel[:p + n], ref_mel[:p + n]))
            prog_mel = k["mel"].to(dev)[p:p + tr["decode_len"]][None]
            ref_wav = RV.generate(w["vocoder"], c["vocoder"], prog_mel)[0]
            got_wav = (RV.generate(w["vocoder"], c["vocoder"], prog_mel, q=low)[0] if control
                       else torch.as_tensor(k["wav"], device=dev))
            m = RV.output_length(c["vocoder"], n)
            wav_err.append(_rel(got_wav[:m], ref_wav[:m]))
        top = lambda xs: max(xs) if xs else None
        return [("t2s_logit_gap", top(gaps), limits["t2s_logit_gap"]),
                ("mel_rel_err", top(mel_err), limits["mel_rel_err"]),
                ("wav_rel_err", top(wav_err), limits["wav_rel_err"])]


def _rel(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))

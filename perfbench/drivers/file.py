"""Per-file generation: `pipeline.Synthesizer.monologue(mode, ...)`, one file
after another, as `monologue_generation.py` runs each file of its folder.

Traffic (the workload's `traffic`): texts of lowercase words (`word_letters`
letters a word, `text_letters` letters a text, so that every text's ids fall
in one bucket of 16), `texts` of them, each with a prompt: an 8 kHz wav of
`prompt_seconds` s of seeded noise and its `.hubert_code.npy` of seeded
units, `prompts` of them written at set-up under the run's temporary
directory. File i takes text i and prompt i, both cycled, and decodes at
the CLI's temperature (the Synthesizer's default, 1). bf16, the fused
vocoder stage and tail (`fuse_tail`).

Check: for `check_files` files (the longest decode first, the rest drawn
from the seed) the flow's mel against the reference ODE on the reference's
own front end (prompt mel from the wav, the packing of prompt and tokens)
with the same y0, and the file's wav against the reference generator on the
program's mel (relative L2 each). The decoded tokens are not compared here:
random decodes of one row repeat one token with wide margins, so the fp8
control changes too few greedy choices to separate from bf16 (PERF.md, Open
questions); `covomix.serve_b64` compares the decode."""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch
from scipy.io import wavfile

from perfbench.lib import flops as FL
from perfbench.lib import models
from perfbench.reference import acoustic as RA
from perfbench.reference import frontend as RF
from perfbench.reference import vocoder as RV
from perfbench.reference.nn import Precision

FLOW_EVALS = 32
SR, HOP = 8000, 160


def make_text(rng, letters_range, word_range) -> str:
    """Lowercase words with a letter count drawn in `letters_range`."""
    target = int(rng.integers(letters_range[0], letters_range[1] + 1))
    words, left = [], target
    while left > 0:
        n = min(left, int(rng.integers(word_range[0], word_range[1] + 1)))
        if 0 < left - n < word_range[0]:
            n = left
        words.append("".join(chr(ord("a") + int(x)) for x in rng.integers(0, 26, n)))
        left -= n
    return " ".join(words)


class Driver:
    def __init__(self, ctx):
        self.ctx, self.tr = ctx, ctx.wl["traffic"]
        self.kept = {}
        self.tmp = None

    def setup(self):
        from covomix_tpu_torch.data.tokenizer import COVOMIX_ADDED_TOKENS, WordPieceTokenizer
        from covomix_tpu_torch.pipeline import Synthesizer

        ctx, tr = self.ctx, self.tr
        models.install_spans(ctx)
        models.wrap(ctx, "covomix_tpu_torch.models.text2semantic:generate", self._tap_generate)
        models.wrap(ctx, "covomix_tpu_torch.models.acoustic:sample", self._tap_sample)
        self.tcfg, self.acfg, self.vcfg = models.program_configs(ctx.cfg)
        w = models.make_weights(ctx)
        tok = WordPieceTokenizer(None, added_tokens=COVOMIX_ADDED_TOKENS)
        common = dict(dtype=models.DTYPES[ctx.cfg["dtype"]], fuse_tail=tr["fuse_tail"],
                      t2s_max_length=tr["t2s_max_length"], bucket=tr["bucket"], device=ctx.device)
        self.synth = Synthesizer(w["t2s"], self.tcfg, w["acoustic"], self.acfg, w["vocoder"], self.vcfg, tok,
                                 **common)
        rng = ctx.rng("inputs")
        self.texts = [make_text(rng, tr["text_letters"], tr["word_letters"]) for _ in range(tr["texts"])]
        self.tmp = tempfile.mkdtemp(prefix="perfbench_prompts_")
        self.prompts = [self._write_prompt(rng, j) for j in range(tr["prompts"])]
        self.gen = ctx.generator("sampling")
        self.pick = ctx.rng("check")
        warm = ctx.rng("warm")                 # the decode graph of the texts' bucket, every kernel
        self.synth.monologue(tr["mode"], make_text(warm, tr["text_letters"], tr["word_letters"]), self.prompts[0],
                             self.gen)
        ctx.sync()

    def _write_prompt(self, rng, j):
        base = os.path.join(self.tmp, f"prompt_{j:03d}")
        n = int(self.tr["prompt_seconds"] * SR)
        wav = np.convolve(rng.standard_normal(n), np.ones(8) / 8, mode="same") * 0.3
        wavfile.write(base + ".wav", SR, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        np.save(base + ".hubert_code.npy", rng.integers(0, 500, n // HOP))
        return base + ".hubert_code.npy"

    def _tap_generate(self, fn):
        def tapped(*args, **kwargs):
            res = fn(*args, **kwargs)
            self._kept_gen = (res.tokens[0].clone(), int(res.lengths[0]), res.num_steps)
            return res
        return tapped

    def _tap_sample(self, fn):
        def tapped(*args, **kwargs):
            gen = kwargs.get("generator", args[2] if len(args) > 2 else None)
            state = gen.get_state() if gen is not None else None
            out = fn(*args, **kwargs)
            self._kept_flow = (out[0].clone(), state, int(kwargs.get("valid_len", out.shape[1])))
            return out
        return tapped

    def step(self, i):
        tr = self.tr
        text, prompt = self.texts[i % len(self.texts)], self.prompts[i % len(self.prompts)]
        wav = self.synth.monologue(tr["mode"], text, prompt, self.gen)
        tokens, n, steps = self._kept_gen
        mel, state, t = self._kept_flow
        self.kept[i] = {"prompt": prompt, "tokens": tokens[:n].cpu(), "mel": mel.cpu(), "state": state,
                        "wav": np.asarray(wav).copy()}
        c = self.ctx.cfg
        ac, tb = c["acoustic"], mel.shape[0]
        s = int(np.ceil((len(RF.encode(text))) / 16.0) * 16)
        g = len(wav) // HOP
        tbv = RF.bucket(g, tr["bucket"])
        flops = (FL.t2s_forward_flops(c["t2s"], 1, s, steps)
                 + FLOW_EVALS * FL.flow_field_flops(ac, 2, tb, valid_len=[t, t])
                 + FL.vocoder_flops(c["vocoder"], 1, tbv))
        flash = FL.flash_forward(2, ac["heads"], tb, ac["dim_head"], valid_len=[t, t])
        fused = FL.vocoder_fused(c["vocoder"], 1, tbv) if tr["fuse_tail"] else []
        failed = int(not (np.isfinite(wav).all() and len(wav) > 0))
        return {"requests": 1, "failed": failed, "audio_s": len(wav) / SR, "flops": flops, "decode_steps": steps,
                "flash_fwd": [(flash[0], flash[1], FLOW_EVALS * ac["depth"])],
                "vocoder_fused": [(f, b, 1) for f, b in fused]}

    def counters(self):
        from covomix_tpu_torch.ops import flash_attention as FA
        from covomix_tpu_torch.ops import vocoder_tail as VT
        return {"flash_fwd_launches": FA.KERNEL.launches, "stage_launches": VT.STAGE.launches,
                "tail_launches": VT.TAIL.launches, "files": len(self.ctx.records),
                "decode_steps": [r.get("decode_steps") for r in self.ctx.records]}

    def release(self):
        self.synth = None
        models.unwrap_all(self.ctx)
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self):
        if self.tmp:
            shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self, control: bool = False):
        ctx, tr = self.ctx, self.tr
        c, dev = ctx.cfg, ctx.device
        w = models.make_weights(ctx)           # drawn again: the reference shares no tensor with the program
        low = Precision("fp8")
        steps = sorted(self.kept)
        longest = max(steps, key=lambda s: len(self.kept[s]["tokens"]))
        rest = [s for s in steps if s != longest]
        flow_files = [longest] + [rest[j] for j in self.pick.permutation(len(rest))[:tr["check_files"] - 1]]
        mel_err, wav_err = [], []
        for s in flow_files:
            k = self.kept[s]
            codes, pmel = RF.read_prompt(k["prompt"])
            ph, cond, t = RF.monologue_rows(codes, pmel, k["tokens"].numpy(), tr["bucket"])
            gen = torch.Generator(device=dev)
            gen.set_state(k["state"])
            y0 = torch.randn((1, len(ph), RA.mel_dim(c["acoustic"])), generator=gen, device=dev, dtype=torch.float32)
            args = (w["acoustic"], c["acoustic"], y0, torch.as_tensor(ph, device=dev)[None],
                    torch.as_tensor(cond, device=dev)[None], torch.tensor([t], device=dev), tr["cond_scale"])
            ref_mel = RA.sample(*args)[0]
            got_mel = RA.sample(*args, q=low)[0] if control else k["mel"].to(dev)
            mel_err.append(_rel(got_mel[:t], ref_mel[:t]))
            p = len(codes)
            voc_in = torch.as_tensor(RF.vocoder_input(k["mel"][p:t].numpy(), tr["bucket"]), device=dev)[None]
            m = (t - p) * HOP
            ref_wav = RV.generate(w["vocoder"], c["vocoder"], voc_in)[0, :m]
            got_wav = (RV.generate(w["vocoder"], c["vocoder"], voc_in, q=low)[0, :m] if control
                       else torch.as_tensor(k["wav"], device=dev))
            wav_err.append(_rel(got_wav, ref_wav))
        limits = ctx.wl["limits"]
        top = lambda xs: max(xs) if xs else None
        return [("mel_rel_err", top(mel_err), limits["mel_rel_err"]),
                ("wav_rel_err", top(wav_err), limits["wav_rel_err"])]


def _rel(a, b):
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))

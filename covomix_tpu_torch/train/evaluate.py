"""Training-time evals (port of covomix_tpu/train/evaluate.py); each one's
'l2' feeds the checkpoint top-k.

  * acoustic (`evaluate_acoustic`): VoSingle ('single') generates the FIRST
    70% of each held-out utterance conditioned on the trailing 30%, MSE over
    the generated region; the two-stream modes take the first half as the
    prompt and generate and score the second half (two_one against the mixed
    mel). Both sample with cond_scale 0.7. Rows are handled at their true
    lengths (pad frames are exactly MEL_PAD = -15 in every dim), which ride
    into `sample` as per-row valid_len, so the score does not depend on
    bucket padding.
  * T2S (`evaluate_t2s`): decode the held-out texts and score the token WER
    between the predicted and the reference token ids after padding both to
    one length with 501 (reported as 'l2'), plus the exact-prefix accuracy
    and a token-level corpus BLEU.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from covomix_tpu_torch.models import acoustic as A, text2semantic as T
from covomix_tpu_torch.train.loop import tree_leaves
from covomix_tpu_torch.util.text_metrics import BleuScorer, levenshtein


def token_wer(ref: Iterable[int], hyp: Iterable[int]) -> float:
    """Word error rate over token-id sequences: edit distance over the
    reference length (0 for two empty sequences, 1 for an empty reference)."""
    ref = list(map(int, ref))
    hyp = list(map(int, hyp))
    if not ref:
        return 0.0 if not hyp else 1.0
    return levenshtein(ref, hyp) / len(ref)


def evaluate_acoustic(params, cfg, eval_batches, generator, *, mask_frac: float = 0.7,
                      cond_scale: float = 0.7, dtype=torch.float32) -> Dict[str, float]:
    """Mean 'l2' over the rows of `eval_batches` (collated numpy batches),
    sampling with `generator` on the parameters' device."""
    device = tree_leaves(params)[0].device
    two = cfg.mode != "single"
    frac = 0.5 if two else mask_frac
    l2s = []
    for batch in eval_batches:
        x = np.asarray(batch["x"])
        lens = (np.abs(x - (-15.0)) > 1e-6).any(-1).sum(-1).astype(np.int32)  # true frames
        if cfg.mode == "two_one":
            target, cond = x[..., -80:], x[..., :-80].copy()
        else:
            target, cond = x, x.copy()
        splits = (lens * frac).astype(int)
        for i in range(x.shape[0]):
            if two:
                cond[i, splits[i]:] = 0.0    # prompt = first half
            else:
                cond[i, : splits[i]] = 0.0   # prompt = trailing context
        pred = A.sample(params, cfg, generator, torch.as_tensor(batch["phonemes"], device=device),
                        torch.as_tensor(cond, device=device), cond_scale=cond_scale,
                        valid_len=torch.as_tensor(lens, device=device), dtype=dtype).cpu().numpy()
        for i in range(x.shape[0]):
            s, li = int(splits[i]), int(lens[i])
            region = slice(s, li) if two else slice(0, s)
            if region.stop > region.start:
                l2s.append(float(np.mean((pred[i, region] - target[i, region]) ** 2)))
    return {"l2": float(np.mean(l2s)) if l2s else float("nan")}


def evaluate_t2s(params, cfg, eval_batches, generator, *, max_length: int = 512, temperature: float = 1.0,
                 cond_scale: float = 1.0, dtype=torch.float32) -> Dict[str, float]:
    """Decode each collated batch's text_ids with `generate` on the
    parameters' device, drawing from `generator`, and score against its
    semantic_ids (two_output: stream 1). Both sequences are padded to one
    length with 501 before the WER (pads then count as matching tokens), as
    the JAX package does. Returns 'l2' (the mean WER), 'accuracy' (mean
    exact-prefix agreement) and 'token_bleu' (corpus BLEU, the sampled EOS
    501 stripped from the hypothesis)."""
    device = tree_leaves(params)[0].device
    wers, accs = [], []
    bleu = BleuScorer(pad=-1, eos=-2, unk=-3)   # ids outside the semantic vocab: nothing is trimmed
    for batch in eval_batches:
        out = T.generate(params, cfg, generator, torch.as_tensor(batch["text_ids"], device=device),
                         max_length=max_length, temperature=temperature, cond_scale=cond_scale, dtype=dtype)
        toks = out.tokens.cpu().numpy()
        sem = np.asarray(batch["semantic_ids"])
        if sem.ndim == 3:
            sem = sem[..., 0]
        for b in range(toks.shape[0]):
            hyp = toks[b][toks[b] != cfg.semantic_pad_id]
            ref = sem[b][sem[b] != 501]
            n = max(len(ref), len(hyp))
            wers.append(token_wer(np.pad(ref, (0, n - len(ref)), constant_values=501),
                                  np.pad(hyp, (0, n - len(hyp)), constant_values=501)))
            m = min(len(ref), len(hyp))
            accs.append(float(np.mean(ref[:m] == hyp[:m])) if m else 0.0)
            bleu.add(ref, hyp[hyp != 501])
    return {"l2": float(np.mean(wers)) if wers else float("nan"),
            "accuracy": float(np.mean(accs)) if accs else float("nan"),
            "token_bleu": bleu.score()}

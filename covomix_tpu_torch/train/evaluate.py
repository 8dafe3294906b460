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
  * file-level evals over validation files (`evaluate_acoustic_files`, the
    VoMix `evaluate_acoustic_two_one_files` / `_two_two_files`, and
    `evaluate_t2s_files`): each file at its exact length, bucket-padded
    (mel 0 / code 501 / text 0) with a scalar valid_len, one y0 drawn from
    the generator per file.
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List

import numpy as np
import torch

from covomix_tpu_torch.data.datasets import CODE_PAD, load_codes
from covomix_tpu_torch.data.oracle import _load_pair, load_two_stream_example
from covomix_tpu_torch.models import acoustic as A, text2semantic as T
from covomix_tpu_torch.train.loop import tree_leaves
from covomix_tpu_torch.util.misc import round_up
from covomix_tpu_torch.util.text_metrics import BleuScorer, levenshtein


def token_wer(ref: Iterable[int], hyp: Iterable[int]) -> float:
    """Word error rate over token-id sequences: edit distance over the
    reference length (0 for two empty sequences, 1 for an empty reference)."""
    ref = list(map(int, ref))
    hyp = list(map(int, hyp))
    if not ref:
        return 0.0 if not hyp else 1.0
    return levenshtein(ref, hyp) / len(ref)


def _padded_wer(ref, hyp) -> float:
    """token_wer after padding both sequences to one length with 501 (the
    pads then count as matching tokens)."""
    n = max(len(ref), len(hyp))
    return token_wer(np.pad(ref, (0, n - len(ref)), constant_values=501),
                     np.pad(hyp, (0, n - len(hyp)), constant_values=501))


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
            wers.append(_padded_wer(ref, hyp))
            m = min(len(ref), len(hyp))
            accs.append(float(np.mean(ref[:m] == hyp[:m])) if m else 0.0)
            bleu.add(ref, hyp[hyp != 501])
    return {"l2": float(np.mean(wers)) if wers else float("nan"),
            "accuracy": float(np.mean(accs)) if accs else float("nan"),
            "token_bleu": bleu.score()}


def _uniform_indices(n_total: int, n_eval: int) -> List[int]:
    """min(n_eval, n_total) indices spread uniformly over [0, n_total - 1]
    (torch.linspace(...).int())."""
    if n_total <= 0:
        return []
    return [int(x) for x in np.linspace(0, n_total - 1, min(n_eval, max(n_total, 1)))]


def _pad_bucket(arr, bucket, pad_value):
    """Pad axis 0 up to a multiple of `bucket` with `pad_value`."""
    n = round_up(arr.shape[0], bucket)
    return np.pad(arr, ((0, n - arr.shape[0]),) + ((0, 0),) * (arr.ndim - 1), constant_values=pad_value)


def _sample_file(params, cfg, generator, codes, cond, t, cond_scale, bucket, dtype):
    """One file's flow sample [T_bucket, mel_dim] (numpy): cond and codes
    bucket-padded (0 / 501), the true length t as a scalar valid_len, so
    the padding stays out of attention."""
    device = tree_leaves(params)[0].device
    cond_p = torch.as_tensor(_pad_bucket(cond, bucket, 0.0), device=device)[None]
    codes_p = torch.as_tensor(_pad_bucket(codes, bucket, CODE_PAD), device=device)[None]
    return A.sample(params, cfg, generator, codes_p, cond_p, cond_scale=cond_scale, valid_len=t,
                    dtype=dtype)[0].cpu().numpy()


def evaluate_acoustic_files(params, cfg, mel_files: List[str], num_eval_files: int, generator, *,
                            cond_scale: float = 0.7, bucket: int = 128, dtype=torch.float32) -> Dict[str, float]:
    """File-level VoSingle eval: files picked uniformly over `mel_files`,
    each mel / code pair at its common length; the first 70 % is generated
    conditioned on the rest and scored (per-file MSE, mean as 'l2')."""
    l2s = []
    for i in _uniform_indices(len(mel_files), num_eval_files):
        mel, codes = _load_pair(mel_files[i])
        t = len(codes)
        split = int(t * 0.7)
        cond = mel.copy()
        cond[:split] = 0.0
        pred = _sample_file(params, cfg, generator, codes, cond, t, cond_scale, bucket, dtype)
        l2s.append(float(np.mean((pred[:split] - mel[:split]) ** 2)))
    return {"l2": float(np.mean(l2s)) if l2s else float("nan")}


def evaluate_acoustic_two_one_files(params, cfg, mel_files: List[str], num_eval_files: int, generator, *,
                                    cond_scale: float = 0.7, bucket: int = 128,
                                    dtype=torch.float32) -> Dict[str, float]:
    """File-level VoMix eval (two input streams, one mixed output): the A / B
    mels condition the first half; the second half of the predicted mixed mel
    is scored against the true mixed mel. A file without a mixed mel is
    skipped."""
    l2s = []
    for i in _uniform_indices(len(mel_files), num_eval_files):
        mel2, codes2, mixed = load_two_stream_example(mel_files[i].replace(".mel.npy", "-A.mel.npy"))
        if mixed is None:
            continue
        t = len(codes2)
        split = int(t * 0.5)
        cond = mel2.copy()
        cond[split:] = 0.0
        pred = _sample_file(params, cfg, generator, codes2, cond, t, cond_scale, bucket, dtype)
        l2s.append(float(np.mean((pred[split:t] - mixed[split:t]) ** 2)))
    return {"l2": float(np.mean(l2s)) if l2s else float("nan")}


def evaluate_acoustic_two_two_files(params, cfg, mel_files: List[str], num_eval_files: int, generator, *,
                                    cond_scale: float = 0.7, bucket: int = 128, dtype=torch.float32,
                                    seed: int = 0) -> Dict[str, float]:
    """File-level VoMix eval (two input, two output streams): the partner
    stream is a random other file's A stream (`random.Random(seed)`); the
    second half is scored against the stacked true mels."""
    rng = random.Random(seed)
    l2s = []
    for i in _uniform_indices(len(mel_files), num_eval_files):
        mel2, codes2, _ = load_two_stream_example(mel_files[i].replace(".mel.npy", "-A.mel.npy"), rng=rng,
                                                  random_partner=mel_files)
        t = len(codes2)
        split = int(t * 0.5)
        cond = mel2.copy()
        cond[split:] = 0.0
        pred = _sample_file(params, cfg, generator, codes2, cond, t, cond_scale, bucket, dtype)
        l2s.append(float(np.mean((pred[split:t] - mel2[split:t]) ** 2)))
    return {"l2": float(np.mean(l2s)) if l2s else float("nan")}


def evaluate_t2s_files(params, cfg, tokenizer, code_files: List[str], num_eval_files: int, generator, *,
                       max_length: int = 2048, temperature: float = 1.0, cond_scale: float = 1.0,
                       bucket: int = 32, dtype=torch.float32) -> Dict[str, float]:
    """File-level T2S eval: files picked uniformly over `code_files`, the
    text from the sibling `.txt` ('-16k.hubert_code.npy' / '_1.hubert_code.npy'
    / '.hubert_code.npy' -> '.txt'), tokenized and padded with 0 to a multiple
    of `bucket`, decoded with no prompt (two_output: stream 1); the WER of the
    decode against the file's codes, both padded to one length with 501,
    averaged over the files as 'l2'."""
    device = tree_leaves(params)[0].device
    wers = []
    for i in _uniform_indices(len(code_files), num_eval_files):
        code_path = code_files[i]
        txt_path = code_path.replace("-16k.hubert_code.npy", ".txt").replace("_1.hubert_code.npy", ".txt")
        if txt_path == code_path:
            txt_path = code_path.replace(".hubert_code.npy", ".txt")
        with open(txt_path) as f:
            text = f.read()
        gt = load_codes(code_path).reshape(-1)
        ids = _pad_bucket(np.asarray(tokenizer.encode(text), np.int32), bucket, 0)
        out = T.generate(params, cfg, generator, torch.as_tensor(ids, device=device)[None], max_length=max_length,
                         temperature=temperature, cond_scale=cond_scale, dtype=dtype)
        hyp = out.tokens[0].cpu().numpy()
        hyp = hyp[hyp != cfg.semantic_pad_id]
        wers.append(_padded_wer(gt, hyp))
    return {"l2": float(np.mean(wers)) if wers else float("nan")}

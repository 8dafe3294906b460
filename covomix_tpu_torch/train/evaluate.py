"""Training-time sampling eval of the acoustic model (port of
`evaluate_acoustic` in covomix_tpu/train/evaluate.py); its 'l2' feeds the
checkpoint top-k.

  * VoSingle ('single'): generate the FIRST 70% of each held-out utterance
    conditioned on the trailing 30%, MSE over the generated region;
  * two-stream modes: the first half is the prompt, the second half is
    generated and scored (two_one against the mixed mel).
Both sample with cond_scale 0.7. Rows are handled at their true lengths
(pad frames are exactly MEL_PAD = -15 in every dim), which ride into `sample`
as per-row valid_len, so the score does not depend on bucket padding."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from covomix_tpu_torch.models import acoustic as A
from covomix_tpu_torch.train.loop import tree_leaves


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

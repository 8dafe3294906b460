"""Batched multi-dialogue serving on one device: port of
covomix_tpu/serving.py's fused cascade (T2S decode -> per-row left-packing ->
flow sampling -> generated-region slice -> vocoder).

Each row is packed as [prompt_i ‖ generated_i ‖ silence filler]; the flow
stage gets one valid length per row (prompt + generated) and the vocoder one
per row (generated frames), so a batched row equals its per-file synthesis."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import acoustic as A
from covomix_tpu_torch.models import text2semantic as T
from covomix_tpu_torch.models import vocoder as V

SILENCE_TOKEN = 157
TOKEN_CLAMP = 501


def slice_generated(mel, starts, length: int):
    """[B, pmax+L, D] -> [B, length, D]: row i's window starts at starts[i]
    (starts <= pmax, so the window never runs past the end)."""
    idx = starts.long()[:, None] + torch.arange(length, device=mel.device)[None, :]
    return torch.gather(mel, 1, idx[..., None].expand(-1, -1, mel.shape[-1]))


def pack_rows(tok1, tok2, gen_lens, prompt_tokens, prompt_mels, prompt_lens, two: bool):
    """Per row: phonemes [prompt[:p] ‖ clip(tokens[:g], 0, 501) ‖ 157] and
    cond [prompt_mel[:p] ‖ 0], both of length pmax + L. Built positionally:
    position j >= p reads token j - p, the result of the JAX package's
    shifted dynamic_slice (whose start never clamps there)."""
    b, L = tok1.shape
    pmax = prompt_tokens.shape[1]
    total = pmax + L
    dev = tok1.device
    j = torch.arange(total, device=dev)[None, :]                       # [1, total]
    p = prompt_lens.long()[:, None]
    g = gen_lens.long()[:, None]
    src = torch.clamp(j - p, 0, L - 1)                                  # generated index
    if two:
        tok = torch.stack([torch.clamp(tok1, 0, TOKEN_CLAMP), torch.clamp(tok2, 0, TOKEN_CLAMP)], dim=-1)
        shifted = torch.gather(tok.long(), 1, src[..., None].expand(-1, -1, 2))
        pt_full = torch.full((b, total, 2), SILENCE_TOKEN, dtype=torch.long, device=dev)
        pt_full[:, :pmax] = prompt_tokens.long()
        sel = torch.where((j < p)[..., None], pt_full,
                          torch.where((j < p + g)[..., None], shifted,
                                      torch.full_like(shifted, SILENCE_TOKEN)))
    else:
        shifted = torch.gather(torch.clamp(tok1, 0, TOKEN_CLAMP).long(), 1, src)
        pt_full = torch.full((b, total), SILENCE_TOKEN, dtype=torch.long, device=dev)
        pt_full[:, :pmax] = prompt_tokens.long()
        sel = torch.where(j < p, pt_full, torch.where(j < p + g, shifted, torch.full_like(shifted, SILENCE_TOKEN)))
    cond = torch.zeros((b, total, prompt_mels.shape[-1]), dtype=torch.float32, device=dev)
    cond[:, :pmax] = prompt_mels.float()
    cond = cond * (j < p)[..., None].float()
    return sel.to(torch.int32), cond


@dataclasses.dataclass
class BatchedPipeline:
    """Fixed-shape batched synthesis on one device: [B] text id rows -> [B]
    waveforms. Parameters may be numpy trees (as `checkpoint.io.load_params`
    returns) or torch trees; they are carried onto `device` once.

    `prompt_frames` and `fused` are the JAX pipeline's fields, accepted and
    without effect: `prompt_frames` is informational there too (the prompt
    length comes from the inputs), and the eager port always runs its stages
    one after another, where JAX may jit the whole cascade as one program.

    `speculative` decodes the T2S stage greedily with `generate_speculative`
    (`spec_gamma` drafts per verify round; the tokens of greedy `generate`).
    It needs the early-exit draft head(s) in the checkpoint, and takes no
    generator, `min_length` or `top_k_thres`: EOS stops the greedy model."""

    t2s_params: dict
    t2s_cfg: T.T2SConfig
    acoustic_params: dict
    acoustic_cfg: A.AcousticConfig
    vocoder_params: dict
    vocoder_cfg: V.VocoderConfig
    decode_len: int = 512
    cond_scale: float = 0.7
    dtype: torch.dtype = torch.bfloat16
    min_length: int = 0        # mask EOS for the first N decode steps
    top_k_thres: float = 0.1
    device: Optional[str] = None   # None -> cuda
    speculative: bool = False  # greedy self-speculative T2S decode (early-exit draft heads)
    spec_gamma: int = 4        # drafts per verify round when speculative
    prompt_frames: int = 400   # informational, as in JAX
    fused: bool = True         # accepted for the JAX signature; no effect here

    def __post_init__(self):
        if self.speculative and not (self.t2s_cfg.target_early_exit_layer > 0 and "early_exit" in self.t2s_params):
            raise AssertionError("speculative serving needs a checkpoint with the early-exit draft head")
        self.device = resolve_device(self.device)
        self.t2s_params = params_from_numpy(self.t2s_params, self.device)
        self.acoustic_params = params_from_numpy(self.acoustic_params, self.device)
        self.vocoder_params = params_from_numpy(self.vocoder_params, self.device)

    def _gen(self, params, generator, source_ids):
        if self.speculative:   # greedy: the generator is not drawn from
            return T.generate_speculative(params, self.t2s_cfg, source_ids, max_length=self.decode_len,
                                          gamma=self.spec_gamma, dtype=self.dtype)
        return T.generate(params, self.t2s_cfg, generator, source_ids, max_length=self.decode_len,
                          min_length=self.min_length, top_k_thres=self.top_k_thres, dtype=self.dtype)

    def place(self, text_ids, prompt_tokens, prompt_mels, prompt_lens=None):
        """Move a batch's inputs onto the device once; returns a tuple to
        splat into repeated calls: pipe(generator, *placed)."""
        b = np.shape(text_ids)[0]
        pt = np.asarray(prompt_tokens)
        if self.acoustic_cfg.n_phoneme_streams == 2 and pt.ndim == 2:
            pt = np.stack([pt, pt], axis=-1)
        if prompt_lens is None:
            prompt_lens = np.full((b,), pt.shape[1], np.int32)
        dev = self.device
        return (torch.as_tensor(np.asarray(text_ids), dtype=torch.int32, device=dev),
                torch.as_tensor(pt, dtype=torch.int32, device=dev),
                torch.as_tensor(np.asarray(prompt_mels), dtype=torch.float32, device=dev),
                torch.as_tensor(np.asarray(prompt_lens), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def __call__(self, generator: Optional[torch.Generator], text_ids, prompt_tokens, prompt_mels,
                 prompt_lens=None, noise=None):
        """text_ids [B, S]; prompt_tokens [B, P] (or [B, P, 2]); prompt_mels
        [B, P, cond_dim]; prompt_lens [B] (default P). `noise` [B, P+L, 80]
        overrides the flow sampler's y0. Returns (wav [B, samples] over the
        generated region, GenerateResult)."""
        two = self.acoustic_cfg.n_phoneme_streams == 2
        if not isinstance(prompt_tokens, torch.Tensor):
            text_ids, prompt_tokens, prompt_mels, prompt_lens = self.place(
                text_ids, prompt_tokens, prompt_mels, prompt_lens)
        else:
            if two and prompt_tokens.dim() == 2:   # one prompt row for both streams, as place() does
                prompt_tokens = torch.stack([prompt_tokens, prompt_tokens], dim=-1)
            if prompt_lens is None:
                prompt_lens = torch.full((prompt_tokens.shape[0],), prompt_tokens.shape[1],
                                         dtype=torch.int32, device=prompt_tokens.device)
        L = self.decode_len
        gen = self._gen(self.t2s_params, generator, text_ids)
        gen_lens = (torch.minimum(gen.lengths, gen.lengths2) if two else gen.lengths).to(torch.int32)
        phonemes, cond = pack_rows(gen.tokens, gen.tokens2, gen_lens, prompt_tokens, prompt_mels,
                                   prompt_lens, two)
        valid = prompt_lens.to(torch.int32) + gen_lens
        mel = A.sample(self.acoustic_params, self.acoustic_cfg, generator, phonemes, cond,
                       cond_scale=self.cond_scale, valid_len=valid, noise=noise, dtype=self.dtype)
        mel_gen = slice_generated(mel, prompt_lens, L)
        wav = V.generator(self.vocoder_params, self.vocoder_cfg, mel_gen, dtype=self.dtype,
                          valid_len=gen_lens)
        return wav, gen

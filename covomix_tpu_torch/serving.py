"""Batched multi-dialogue serving: port of covomix_tpu/serving.py's fused
cascade (T2S decode -> per-row left-packing -> flow sampling ->
generated-region slice -> vocoder), on one device or with its rows over a
dp mesh.

Each row is packed as [prompt_i ‖ generated_i ‖ silence filler]; the flow
stage gets one valid length per row (prompt + generated) and the vocoder one
per row (generated frames), so a batched row equals its per-file synthesis.

With `mesh` (parallel/mesh.py, one process per device) the parameters are
replicated and each rank packs, samples and vocodes its dp index's rows of
the batch, as JAX shards the rows over 'dp': the T2S draws and the flow's
y0 are the global batch's (each rank keeps its rows) and the decode's stop
is decided over dp, so a row's result does not depend on the split. The
wav and the GenerateResult are gathered over dp (the collective chosen by
the group's backend name) and every rank returns the global batch's."""

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
from covomix_tpu_torch.parallel.mesh import all_gather
from covomix_tpu_torch.util import profiling

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
    generator, `min_length` or `top_k_thres`: EOS stops the greedy model.

    `mesh`: a dp mesh in a process group (module docstring); B must divide
    by its dp, `device` is the rank's. None: one device."""

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
    mesh: Optional[object] = None   # a parallel/mesh.py Mesh: the rows over its dp ranks

    def __post_init__(self):
        if self.speculative and not (self.t2s_cfg.target_early_exit_layer > 0 and "early_exit" in self.t2s_params):
            raise AssertionError("speculative serving needs a checkpoint with the early-exit draft head")
        self.device = resolve_device(self.device)
        self.t2s_params = params_from_numpy(self.t2s_params, self.device)
        self.acoustic_params = params_from_numpy(self.acoustic_params, self.device)
        self.vocoder_params = params_from_numpy(self.vocoder_params, self.device)
        self.calls = 0             # calls made, the `serve.call` span's number

    def _gen(self, params, generator, source_ids):
        if self.speculative:   # greedy: the generator is not drawn from
            if self.mesh is None:
                return T.generate_speculative(params, self.t2s_cfg, source_ids, max_length=self.decode_len,
                                              gamma=self.spec_gamma, dtype=self.dtype)
            return T.generate_speculative_rows(params, self.t2s_cfg, source_ids, self.mesh,
                                               max_length=self.decode_len, gamma=self.spec_gamma, dtype=self.dtype)
        return T.generate(params, self.t2s_cfg, generator, source_ids, max_length=self.decode_len,
                          min_length=self.min_length, top_k_thres=self.top_k_thres, dtype=self.dtype,
                          mesh=self.mesh)

    def _rows(self, x):
        """This rank's rows of a global batch's array (all of them without a mesh)."""
        if self.mesh is None:
            return x
        b = x.shape[0]
        if b % self.mesh.dp:
            raise ValueError(f"batch of {b} rows does not divide by dp={self.mesh.dp}")
        return x[self.mesh.rows(b // self.mesh.dp)]

    def _gather(self, x):
        """The global batch's rows of a per-rank tensor, on every rank."""
        if self.mesh is None:
            return x
        return all_gather(x.contiguous(), 0, self.mesh.dp_group, self.mesh.dp, self.mesh.dp_rank)

    def place(self, text_ids, prompt_tokens, prompt_mels, prompt_lens=None):
        """Move a batch's inputs onto the device once (with a mesh, this
        rank's rows of them); returns a tuple to splat into repeated calls:
        pipe(generator, *placed)."""
        b = np.shape(text_ids)[0]
        pt = np.asarray(prompt_tokens)
        if self.acoustic_cfg.n_phoneme_streams == 2 and pt.ndim == 2:
            pt = np.stack([pt, pt], axis=-1)
        if prompt_lens is None:
            prompt_lens = np.full((b,), pt.shape[1], np.int32)
        dev = self.device
        return (torch.as_tensor(self._rows(np.asarray(text_ids)), dtype=torch.int32, device=dev),
                torch.as_tensor(self._rows(pt), dtype=torch.int32, device=dev),
                torch.as_tensor(self._rows(np.asarray(prompt_mels)), dtype=torch.float32, device=dev),
                torch.as_tensor(self._rows(np.asarray(prompt_lens)), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def __call__(self, generator: Optional[torch.Generator], text_ids, prompt_tokens, prompt_mels,
                 prompt_lens=None, noise=None):
        """text_ids [B, S]; prompt_tokens [B, P] (or [B, P, 2]); prompt_mels
        [B, P, cond_dim]; prompt_lens [B] (default P); tensors are taken as
        placed (`place`: with a mesh, the rank's rows). `noise` [B, P+L, 80]
        (the global batch's) overrides the flow sampler's y0. Returns (wav
        [B, samples] over the generated region, GenerateResult), with a mesh
        the global batch's on every rank."""
        self.calls += 1
        with profiling.scope("serve.call", self.calls):
            two = self.acoustic_cfg.n_phoneme_streams == 2
            with profiling.scope("serve.place"):
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
            with profiling.scope("serve.pack"):
                gen_lens = (torch.minimum(gen.lengths, gen.lengths2) if two else gen.lengths).to(torch.int32)
                phonemes, cond = pack_rows(gen.tokens, gen.tokens2, gen_lens, prompt_tokens, prompt_mels,
                                           prompt_lens, two)
                valid = prompt_lens.to(torch.int32) + gen_lens
            mel = A.sample(self.acoustic_params, self.acoustic_cfg, generator, phonemes, cond,
                           cond_scale=self.cond_scale, valid_len=valid,
                           noise=None if noise is None else self._rows(noise), dtype=self.dtype, mesh=self.mesh)
            with profiling.scope("serve.slice"):
                mel_gen = slice_generated(mel, prompt_lens, L)
            wav = V.generator(self.vocoder_params, self.vocoder_cfg, mel_gen, dtype=self.dtype,
                              valid_len=gen_lens)
            if self.mesh is None:
                return wav, gen
            return self._gather(wav), T.GenerateResult(*(self._gather(x) for x in gen[:4]), gen.num_steps)

"""Batched dialogue serving CLI on one device: N scripts -> N wavs.

    python -m covomix_tpu_torch.serve_batch --t2s_ckpt t2s.npz --acous_ckpt ac.npz \
        --hifigan_ckpt voc.npz --text_dir scripts/ --prompt_dir prompts/ [--device cuda]

Checkpoints are the `.npz` + `.json` files that `checkpoint.io.save_params`
(or `convert_checkpoint`) writes, or the released PyTorch files (Lightning
`.ckpt`, HiFi-GAN `g_<step>` + `vocoder_config.json`), read directly. Scripts follow
dialogue_generation.py's conventions: `<name>.txt` with
`<name>_1.hubert_code.npy` / `<name>_2.hubert_code.npy` prompts (+ sibling wavs
or `.mel.npy` caches)."""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import MelConfig, save_wav
from covomix_tpu_torch.data.tokenizer import load_covomix_tokenizer
from covomix_tpu_torch.models import acoustic as A, text2semantic as T, vocoder as V
from covomix_tpu_torch.pipeline import PARALLEL_ITEM, clean_text, load_checkpoint, prepare_prompt
from covomix_tpu_torch.serving import SILENCE_TOKEN, BatchedPipeline


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--t2s_ckpt", required=True)
    p.add_argument("--acous_ckpt", required=True)
    p.add_argument("--hifigan_ckpt", required=True)
    p.add_argument("--text_dir", required=True)
    p.add_argument("--prompt_dir", required=True)
    p.add_argument("--saved_dir", default="served")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--decode_len", type=int, default=512)
    p.add_argument("--max_text_tokens", type=int, default=128)
    p.add_argument("--seed", type=int, default=30)
    p.add_argument("--bert_vocab", type=str, default=None)
    p.add_argument("--allow_fallback_vocab", action="store_true",
                   help="permit the checkpoint-incompatible char-level fallback vocab")
    p.add_argument("--bf16", action="store_true", help="force bfloat16 compute (default on cuda)")
    p.add_argument("--f32", action="store_true", help="force float32 compute (default on cpu)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu must be asked for)")
    p.add_argument("--staged", action="store_true",
                   help="run the stages one after another (the eager port always does)")
    p.add_argument("--speculative", action="store_true",
                   help="greedy self-speculative T2S decode (needs a checkpoint trained "
                        "with the early-exit draft head(s); output == greedy decode)")
    p.add_argument("--spec_gamma", type=int, default=4,
                   help="speculative drafts per verify round")
    p.add_argument("--multihost", action="store_true", help="multi-host serving (not ported yet: raises)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.multihost:
        raise NotImplementedError(f"--multihost: multi-host serving is not ported yet ({PARALLEL_ITEM})")
    device = resolve_device(args.device)
    if args.f32:
        dtype = torch.float32
    elif args.bf16 or device.type == "cuda":
        dtype = torch.bfloat16
    else:
        dtype = torch.float32
    t2s_params, t2s_cfg = load_checkpoint(args.t2s_ckpt, T.T2SConfig)
    ac_params, ac_cfg = load_checkpoint(args.acous_ckpt, A.AcousticConfig)
    voc_params, voc_cfg = load_checkpoint(args.hifigan_ckpt, V.VocoderConfig)
    tok = load_covomix_tokenizer(args.bert_vocab, strict=not args.allow_fallback_vocab)
    mel_cfg = MelConfig(sample_rate=voc_cfg.sampling_rate)
    pipe = BatchedPipeline(t2s_params, t2s_cfg, ac_params, ac_cfg, voc_params, voc_cfg,
                           decode_len=args.decode_len, dtype=dtype, device=device,
                           speculative=args.speculative, spec_gamma=args.spec_gamma)

    os.makedirs(args.saved_dir, exist_ok=True)
    scripts = sorted(glob.glob(os.path.join(args.text_dir, "*.txt")))
    print(f"{len(scripts)} scripts, batch {args.batch}, device {device}")
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    hop = mel_cfg.hop_size
    for start in range(0, len(scripts), args.batch):
        chunk = scripts[start: start + args.batch]
        b = len(chunk)
        padded = chunk + [chunk[-1]] * (args.batch - b)   # static batch; repeats trimmed after
        texts, prompts_tok, prompts_mel, plens = [], [], [], []
        for path in padded:
            with open(path, encoding="utf-8") as f:
                texts.append(f.read())
            base = os.path.basename(path).replace(".txt", "")
            s1, m1 = prepare_prompt(os.path.join(args.prompt_dir, base + "_1.hubert_code.npy"), mel_cfg, device)
            s2, m2 = prepare_prompt(os.path.join(args.prompt_dir, base + "_2.hubert_code.npy"), mel_cfg, device)
            n = min(len(s1), len(s2))
            prompts_tok.append(np.stack([s1[:n], s2[:n]], -1))
            prompts_mel.append(np.concatenate([m1[:n], m2[:n]], -1))
            plens.append(n)
        pmax = max(plens)
        tok_arr = np.full((args.batch, pmax, 2), SILENCE_TOKEN, np.int32)
        mel_arr = np.zeros((args.batch, pmax, prompts_mel[0].shape[-1]), np.float32)
        for i, (t, m) in enumerate(zip(prompts_tok, prompts_mel)):
            tok_arr[i, : len(t)] = t
            mel_arr[i, : len(m)] = m
        ids, _ = tok.batch_encode([clean_text(t) for t in texts], max_length=args.max_text_tokens)
        if ids.shape[1] < args.max_text_tokens:
            ids = np.pad(ids, ((0, 0), (0, args.max_text_tokens - ids.shape[1])))
        t0 = time.time()
        wav, res = pipe(gen, ids, tok_arr, mel_arr, prompt_lens=np.asarray(plens, np.int32))
        wav = wav.cpu().numpy()
        lengths = torch.minimum(res.lengths, res.lengths2).cpu().numpy()
        wall = time.time() - t0
        for i, path in enumerate(chunk):
            out = os.path.join(args.saved_dir, os.path.basename(path).replace(".txt", ".wav"))
            save_wav(out, wav[i, : max(int(lengths[i]) * hop, hop)], mel_cfg.sample_rate)
        audio_s = max(float(lengths[:b].sum()) * hop / mel_cfg.sample_rate, 1e-6)
        print(f"batch of {b}: {wall:.2f}s wall for {audio_s:.0f}s audio (RTF {wall / audio_s:.4f})")


if __name__ == "__main__":
    main()

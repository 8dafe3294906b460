"""Monologue synthesis CLI on one device: one wav per script.

    python -m covomix_tpu_torch.monologue_generation --t2s_ckpt t2s.npz --acous_ckpt ac.npz \\
        --hifigan_ckpt voc.npz --text_dir scripts/ --prompt_dir prompts/ [--mode covosingle] [--device cuda]

Same flags, modes (covosingle / covosinx / covomix) and file conventions as
the JAX package's monologue_generation.py: per `<name>.txt` in --text_dir, a
prompt `<name>.hubert_code.npy` (+ sibling `.wav` or `.mel.npy`) in
--prompt_dir, output `<name>.wav` (8 kHz int16) in --saved_dir, plus a
config.txt provenance file. `--device` (default cuda) picks the device; bf16
is the default on cuda, f32 on cpu.

Checkpoints are `.npz` files with a `.json` config sidecar (as the
`checkpoint.io.save_params` of either package and `convert_checkpoint` write
them), or the released PyTorch files, read directly as the JAX CLIs read
them: Lightning `.ckpt` for the T2S and acoustic models, HiFi-GAN
`g_<step>` with the `vocoder_config.json` beside it."""

from __future__ import annotations

import argparse
import glob
import os
import time

import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import save_wav
from covomix_tpu_torch.models import text2semantic as T
from covomix_tpu_torch.pipeline import Synthesizer, load_synthesizer


def add_args(parser: argparse.ArgumentParser, *, mode: str, prompt_dir: str) -> None:
    """The flags both generation CLIs share (the JAX CLIs' plus --device)."""
    parser.add_argument("--t2s_ckpt", type=str, required=True,
                        help="text2semantic checkpoint (.npz or Lightning .ckpt)")
    parser.add_argument("--acous_ckpt", type=str, required=True,
                        help="acoustic model checkpoint (.npz or Lightning .ckpt)")
    parser.add_argument("--hifigan_ckpt", type=str, required=True,
                        help="HiFi-GAN vocoder checkpoint (.npz or g_<step>)")
    parser.add_argument("--text_dir", type=str, default="test/test_dir")
    parser.add_argument("--prompt_dir", type=str, default=prompt_dir)
    parser.add_argument("--saved_dir", type=str, default=".saved_dir")
    parser.add_argument("--seed", type=int, default=30)
    parser.add_argument("--mode", type=str, choices=["covosingle", "covosinx", "covomix"], default=mode)
    parser.add_argument("--bert_vocab", type=str, default=None, help="path to bert-base-uncased vocab.txt")
    parser.add_argument("--allow_fallback_vocab", action="store_true",
                        help="permit the checkpoint-incompatible char-level fallback vocab "
                             "(random-weight smoke runs only)")
    parser.add_argument("--fuse_tail", action="store_true",
                        help="vocode without valid_len so the fused stage/tail kernels run on cuda "
                             "(the last ~0.3 s of each wav approximates exact-length inference)")
    parser.add_argument("--speculative", action="store_true",
                        help="greedy self-speculative T2S decode (needs a checkpoint trained "
                             "with an early-exit head; CoMix two-stream needs this "
                             "framework's stream-2 draft head)")
    parser.add_argument("--bf16", action="store_true", help="force bfloat16 compute (default on cuda)")
    parser.add_argument("--f32", action="store_true", help="force float32 compute (default on cpu)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu must be asked for)")


def load_models(args) -> Synthesizer:
    device = resolve_device(args.device)
    if args.f32:
        dtype = torch.float32
    elif args.bf16 or device.type == "cuda":
        dtype = torch.bfloat16
    else:
        dtype = torch.float32
    return load_synthesizer(args.t2s_ckpt, args.acous_ckpt, args.hifigan_ckpt, vocab_path=args.bert_vocab,
                            strict=not args.allow_fallback_vocab, dtype=dtype, fuse_tail=args.fuse_tail,
                            speculative=args.speculative, device=device)


def generate_all(args, kind: str, synthesize) -> None:
    """Load the models, write config.txt, then per script in --text_dir call
    synthesize(synth, text, base path without .txt, generator) and save the
    wav, printing its audio seconds and RTF; last the decode counts
    (`text2semantic.DECODE`)."""
    os.makedirs(args.saved_dir, exist_ok=True)
    synth = load_models(args)
    with open(os.path.join(args.saved_dir, "config.txt"), "w") as f:
        f.write(f"Vocoder: {args.hifigan_ckpt}\n")
        f.write(f"t2s_ckpt: {args.t2s_ckpt}\n")
        f.write(f"acoustic model: {args.acous_ckpt}\n")
    gen = torch.Generator(device=synth.device)
    gen.manual_seed(args.seed)
    text_list = sorted(glob.glob(os.path.join(args.text_dir, "*.txt")))
    print(f"{len(text_list)} {kind}; mode={args.mode}; device {synth.device}, {synth.dtype}", flush=True)
    for text_file in text_list:
        base = os.path.basename(text_file)[: -len(".txt")]
        with open(text_file, encoding="utf-8") as f:
            text = f.read()
        t0 = time.time()
        wav = synthesize(synth, text, base, gen)
        dur = len(wav) / synth.mel_cfg.sample_rate
        out = os.path.join(args.saved_dir, base + ".wav")
        save_wav(out, wav, synth.mel_cfg.sample_rate)
        wall = time.time() - t0
        print(f"saved {out}  ({dur:.1f}s audio, RTF {wall / max(dur, 1e-6):.3f})", flush=True)
    print(T.DECODE, flush=True)     # a capture per text bucket; more means graphs were built again


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_args(parser, mode="covosingle", prompt_dir="test/monologue_prompt_dir")
    args = parser.parse_args(argv)
    generate_all(args, "scripts", lambda synth, text, base, gen: synth.monologue(
        args.mode, text, os.path.join(args.prompt_dir, base + ".hubert_code.npy"), gen))


if __name__ == "__main__":
    main()

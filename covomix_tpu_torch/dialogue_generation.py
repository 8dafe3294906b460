"""Dialogue synthesis CLI on one device: one two-speaker wav per script.

    python -m covomix_tpu_torch.dialogue_generation --t2s_ckpt t2s.npz --acous_ckpt ac.npz \\
        --hifigan_ckpt voc.npz --text_dir scripts/ --prompt_dir prompts/ [--mode covomix] [--device cuda]

Same flags and conventions as the JAX package's dialogue_generation.py:
scripts contain `[spkchange]` turn markers; prompts are
`<name>_1.hubert_code.npy` / `<name>_2.hubert_code.npy` (+ sibling `.wav` or
`.mel.npy`) per speaker. Modes:
  covosingle  per-turn synthesis alternating prompts, waveform concat
  covosinx    per-turn T2S routed into 2 token streams, one VoMix pass
  covomix     the full script through the CoMix dual-stream decode + VoMix
Flags, checkpoints and devices as in `covomix_tpu_torch.monologue_generation`."""

from __future__ import annotations

import argparse
import os

from covomix_tpu_torch.monologue_generation import add_args, generate_all


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_args(parser, mode="covomix", prompt_dir="test/dialogue_prompt_dir")
    args = parser.parse_args(argv)

    def synthesize(synth, text, base, gen):
        p1 = os.path.join(args.prompt_dir, base + "_1.hubert_code.npy")
        p2 = os.path.join(args.prompt_dir, base + "_2.hubert_code.npy")
        return synth.dialogue(args.mode, text, p1, p2, gen)

    generate_all(args, "dialogue scripts", synthesize)


if __name__ == "__main__":
    main()

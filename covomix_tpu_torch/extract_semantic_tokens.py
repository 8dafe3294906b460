"""Batched HuBERT semantic-token extraction on one device (the port of
extract_semantic_tokens.py).

    python -m covomix_tpu_torch.extract_semantic_tokens --data_dir wavs/ \\
        --hubert_ckpt hubert.npz [--out_dir codes/] [--bf16] [--device cuda]

Globs wavs under --data_dir, runs the HuBERT tokenizer (layer-12 features,
500-unit k-means) and writes `<name>.hubert_code.npy` as a string array (the
reference consumers `.astype(int)` it) next to each wav, or under --out_dir
with the subpaths mirrored. Files are bucketed by length (`batch_by_size`,
at most 16 rows and --batch_tokens samples per batch) and padded to 5 s
multiples; each batch passes both the true sample counts and the frame
padding mask, so a padded row gives the ids of its exact-length extraction.

--hubert_ckpt takes an `.npz` (as convert_checkpoint writes it) or a fairseq
`.pt` with --km_path (a joblib k-means `.bin`, which needs joblib and
scikit-learn); without one the weights are random (seed 0), for smoke runs.
The compute type is f32 unless --bf16."""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import load_wav
from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.checkpoint import torch_convert as tc
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.data.batching import batch_by_size
from covomix_tpu_torch.models import hubert as H
from covomix_tpu_torch.util.misc import round_up

BUCKET = 16000 * 5   # pad waveforms to 5 s multiples
MAX_ROWS = 16


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--pattern", type=str, default="*.wav")
    p.add_argument("--hubert_ckpt", type=str, default=None,
                   help="fairseq hubert_fisher.pt or converted .npz; random init if omitted (smoke mode)")
    p.add_argument("--km_path", type=str, default=None, help="joblib k-means .bin (500 units)")
    p.add_argument("--out_dir", type=str, default=None, help="default: next to each wav")
    p.add_argument("--channel", type=int, default=None, help="channel index for multi-channel wavs")
    p.add_argument("--batch_tokens", type=int, default=16000 * 120, help="max total samples per batch")
    p.add_argument("--suffix", type=str, default=".hubert_code.npy")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = H.HubertConfig()
    if args.hubert_ckpt is None:
        print("WARNING: no --hubert_ckpt; using random weights (token ids will be meaningless)")
        params = H.init(torch.Generator(device=device).manual_seed(0), cfg)
    elif args.hubert_ckpt.endswith(".npz"):
        params = params_from_numpy(cio.load_params(args.hubert_ckpt), device)
    else:
        params = params_from_numpy(tc.convert_hubert_ckpt(args.hubert_ckpt, args.km_path), device)
    if args.km_path and not (args.hubert_ckpt and not args.hubert_ckpt.endswith(".npz")):
        # the .pt conversion above merges the centroids itself
        params["kmeans"] = torch.from_numpy(tc.load_kmeans(args.km_path)).to(device)

    files = sorted(glob.glob(os.path.join(args.data_dir, "**", args.pattern), recursive=True))
    print(f"{len(files)} wavs", flush=True)
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    wavs, lengths = [], []
    for f in files:
        w, _ = load_wav(f, sr=cfg.sample_rate, channel=args.channel)
        if cfg.normalize:
            w = (w - w.mean()) / np.sqrt(w.var() + 1e-5)
        wavs.append(w)
        lengths.append(len(w))

    t0 = time.time()
    total_frames = 0
    for batch_idx in batch_by_size(lengths, max_tokens=args.batch_tokens, max_sentences=MAX_ROWS):
        padded = round_up(max(lengths[i] for i in batch_idx), BUCKET)
        batch = np.zeros((len(batch_idx), padded), np.float32)
        frames_valid = []
        for row, i in enumerate(batch_idx):
            batch[row, : lengths[i]] = wavs[i]
            frames_valid.append(H.num_output_frames(cfg, lengths[i]))
        n_frames = H.num_output_frames(cfg, padded)
        mask = torch.arange(n_frames, device=device)[None, :] < torch.tensor(frames_valid, device=device)[:, None]
        ids = H.wav2units_batch(params, cfg, torch.from_numpy(batch).to(device), padding_mask=mask,
                                valid_samples=torch.tensor([lengths[i] for i in batch_idx], device=device),
                                dtype=dtype).cpu().numpy()
        for row, i in enumerate(batch_idx):
            if args.out_dir:
                # mirror the subpath, so same-named wavs in different directories stay apart
                rel = os.path.relpath(os.path.dirname(files[i]), args.data_dir)
                out_dir = os.path.normpath(os.path.join(args.out_dir, rel))
            else:
                out_dir = os.path.dirname(files[i])
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.basename(files[i]).rsplit(".wav", 1)[0] + args.suffix
            np.save(os.path.join(out_dir, name), ids[row, : frames_valid[row]].astype(str))
            total_frames += frames_valid[row]
    wall = time.time() - t0
    audio_s = sum(lengths) / cfg.sample_rate
    print(f"done: {total_frames} tokens from {audio_s:.0f}s audio in {wall:.1f}s "
          f"({total_frames / max(wall, 1e-9):.1f} tokens/s, {audio_s / max(wall, 1e-9):.1f}x realtime)", flush=True)


if __name__ == "__main__":
    main()

"""Batch mel extraction: wavs -> `.mel.npy` (the 8 kHz / 20 ms CoVoMix
config), on one device.

    python -m covomix_tpu_torch.prepare_mels --data_path wavs/ [--save_path mels/] [--device cuda]

Globs the wavs under --data_path, and writes `<name>.mel.npy` [num_mels,
frames] next to each wav, or under --save_path with the subpaths mirrored
(so same-named wavs in different directories stay apart). Files are bucketed
by length (`batch_by_size`, at most 32 rows and 600 s of samples per batch)
and padded to 5 s multiples; each row's own tail is reflected into its pad
region, so the frames whose window crosses the true end see the signal that
a per-file extraction's reflect pad gives them. Every file's mel is cut to
`mel_frames_for_samples` of its length."""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import MelConfig, load_wav, mel_frames_for_samples, mel_spectrogram
from covomix_tpu_torch.data.batching import batch_by_size
from covomix_tpu_torch.util.misc import round_up


def padded_batch(wavs, lengths, batch_idx, bucket: int, n_fft: int) -> np.ndarray:
    """[rows, padded] f32 rows of the batch, padded to a multiple of `bucket`
    with each row's tail reflected into its first n_fft pad samples."""
    padded = round_up(max(lengths[i] for i in batch_idx), bucket)
    batch = np.zeros((len(batch_idx), padded), np.float32)
    for row, i in enumerate(batch_idx):
        n = lengths[i]
        batch[row, :n] = wavs[i]
        refl = min(n_fft, n - 1, padded - n)
        if refl > 0:
            batch[row, n: n + refl] = wavs[i][n - 1 - refl: n - 1][::-1]
    return batch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_path", required=True)
    p.add_argument("--save_path", default=None, help="default: next to each wav")
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--n_fft", type=int, default=480)
    p.add_argument("--hop_size", type=int, default=160)
    p.add_argument("--win_size", type=int, default=480)
    p.add_argument("--num_mels", type=int, default=80)
    p.add_argument("--fmin", type=float, default=0.0)
    p.add_argument("--fmax", type=float, default=4000.0)
    p.add_argument("--channel", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = MelConfig(args.sample_rate, args.n_fft, args.num_mels, args.hop_size, args.win_size, args.fmin, args.fmax)
    files = sorted(glob.glob(os.path.join(args.data_path, "**", "*.wav"), recursive=True))
    print(f"{len(files)} wavs")
    wavs, lengths = [], []
    for f in files:
        w, _ = load_wav(f, sr=cfg.sample_rate, channel=args.channel)
        wavs.append(np.clip(w, -1, 1))
        lengths.append(len(w))
    for batch_idx in batch_by_size(lengths, max_tokens=cfg.sample_rate * 600, max_sentences=32):
        batch = padded_batch(wavs, lengths, batch_idx, cfg.sample_rate * 5, cfg.n_fft)
        mels = mel_spectrogram(torch.from_numpy(batch).to(device), cfg).cpu().numpy()
        for row, i in enumerate(batch_idx):
            if args.save_path:
                rel = os.path.relpath(os.path.dirname(files[i]), args.data_path)
                out_dir = os.path.normpath(os.path.join(args.save_path, rel))
            else:
                out_dir = os.path.dirname(files[i])
            os.makedirs(out_dir, exist_ok=True)
            name = os.path.basename(files[i]).rsplit(".wav", 1)[0] + ".mel.npy"
            np.save(os.path.join(out_dir, name), mels[row, :, : mel_frames_for_samples(lengths[i], cfg)])
    print("done")


if __name__ == "__main__":
    main()

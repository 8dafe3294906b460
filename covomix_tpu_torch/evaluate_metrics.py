"""Offline metric table: generated wavs against ground-truth wavs -> CSV.

    python -m covomix_tpu_torch.evaluate_metrics --gen_dir gen/ --ref_dir ref/ [--out_csv m.csv] [--device cuda]

Pairs are matched by basename (`x_generated.wav` in --gen_dir pairs with
`x.wav` in --ref_dir), both cut to the shorter length. Per pair: PESQ-nb
(the numpy P.862-style approximation), SI-SDR, STOI, ESTOI and MCD (on the
log-mels, computed on --device), each rounded as the columns show; the CSV
ends with one `# key: mean +- std` line per column. Exits 1 when no pair
matches."""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import MelConfig, load_wav, mel_spectrogram
from covomix_tpu_torch.util.metrics import estoi, mcd, si_sdr, stoi
from covomix_tpu_torch.util.misc import mean_std
from covomix_tpu_torch.util.pesq_nb import pesq_nb

COLUMNS = ("pesq_nb_approx", "si_sdr", "stoi", "estoi", "mcd_db")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--gen_dir", required=True)
    p.add_argument("--ref_dir", required=True)
    p.add_argument("--out_csv", default="metrics.csv")
    p.add_argument("--sample_rate", type=int, default=8000)
    p.add_argument("--device", default="cuda", help="torch device of the mels (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    mel_cfg = MelConfig(sample_rate=args.sample_rate)

    def log_mel(w):
        return mel_spectrogram(torch.from_numpy(w[None]).to(device), mel_cfg)[0].T.cpu().numpy()

    rows = []
    for gen in sorted(glob.glob(os.path.join(args.gen_dir, "*.wav"))):
        name = os.path.basename(gen).replace("_generated", "")
        ref = os.path.join(args.ref_dir, name)
        if not os.path.isfile(ref):
            continue
        g, _ = load_wav(gen, sr=args.sample_rate)
        r, _ = load_wav(ref, sr=args.sample_rate)
        n = min(len(g), len(r))
        g, r = g[:n], r[:n]
        rows.append({
            "file": name,
            "pesq_nb_approx": round(pesq_nb(r, g, args.sample_rate), 4),
            "si_sdr": round(si_sdr(r, g), 3),
            "stoi": round(stoi(r, g, args.sample_rate), 4),
            "estoi": round(estoi(r, g, args.sample_rate), 4),
            "mcd_db": round(mcd(log_mel(r), log_mel(g)), 4),
        })
        print(rows[-1])
    if not rows:
        print("no matched pairs", file=sys.stderr)
        sys.exit(1)
    with open(args.out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
        for key in COLUMNS:
            m, s = mean_std(np.asarray([row[key] for row in rows], float))
            f.write(f"# {key}: {m:.4f} +- {s:.4f}\n")
            print(f"{key}: {m:.4f} +- {s:.4f}")
    print(f"wrote {args.out_csv}")


if __name__ == "__main__":
    main()

"""HiFi-GAN inference and copy-synthesis evaluation on one device (the port of
hifigan_inference.py).

    python -m covomix_tpu_torch.hifigan_inference --checkpoint_file g_00400000 \\
        --input_wavs_dir wavs/ --output_dir out/ [--metrics_csv m.csv] [--fuse_tail] [--device cuda]

Modes:
  --input_wavs_dir : wav -> mel -> wav copy synthesis, with PESQ-nb (the
                     numpy approximation), SI-SNR, STOI, ESTOI, MCD and the
                     per-file RTF against the input, one row per file and
                     their mean (hifi-gan/inference.py:44-80)
  --input_mels_dir : mel.npy -> wav (hifi-gan/inference_e2e.py:35-62)

The checkpoint is an `.npz` (+ `.json` sidecar; --config overlays the mel
analysis keys) or a HiFi-GAN `g_<step>` with --config or the
vocoder_config.json beside it. The generator runs in f32, as in the JAX
CLI. Mel frames are bucketed to multiples of 64 (pad -15, the training pad
value). The default path passes the true length as `valid_len`, so the
trimmed wav equals exact-length vocoding; `--fuse_tail` runs the fused stage
and tail kernels, which are static-length: the last ~16 frames (~0.3 s) of
each wav approximate exact-length inference there."""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import time

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import MelConfig, load_wav, mel_spectrogram, save_wav
from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.checkpoint import torch_convert as tc
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.models import vocoder as V
from covomix_tpu_torch.util.metrics import estoi, mcd, si_sdr, stoi
from covomix_tpu_torch.util.misc import round_up
from covomix_tpu_torch.util.pesq_nb import pesq_nb

MEL_PAD = -15.0   # training-time pad value (data_module.py:846)
MEL_BUCKET = 64


def load_vocoder(path: str, config: str | None = None):
    """(numpy parameter tree, config dict) of an `.npz` or a `g_<step>`. The
    dict holds the generator's keys and, where given, the mel analysis keys
    (n_fft, hop_size, win_size, fmin, fmax)."""
    if path.endswith(".npz"):
        c = dict(cio.load_meta(path).get("config", {}))
        if config:
            with open(config) as f:
                c.update(json.load(f))
        return cio.load_params(path), c
    with open(config or os.path.join(os.path.dirname(path), "vocoder_config.json")) as f:
        c = json.load(f)
    return tc.convert_hifigan_ckpt(path, c), c


def mel_config(c: dict, sr: int, num_mels: int) -> MelConfig:
    return MelConfig(sr, int(c.get("n_fft", 480)), num_mels, int(c.get("hop_size", 160)),
                     int(c.get("win_size", 480)), float(c.get("fmin", 0)), float(c.get("fmax", sr / 2)))


def vocode(params, cfg: V.VocoderConfig, mel: torch.Tensor, fuse_tail: bool) -> torch.Tensor:
    """mel [1, T, num_mels] (on the parameters' device) -> wav
    [1, output_length(T)] f32, with the frames bucketed to a multiple of 64.
    Without `fuse_tail` the true length goes in as `valid_len`."""
    t = mel.shape[1]
    tb = round_up(t, MEL_BUCKET)
    if tb != t:
        mel = torch.nn.functional.pad(mel, (0, 0, 0, tb - t), value=MEL_PAD)
    if fuse_tail:
        out = V.generator(params, cfg, mel, fuse_tail=True)
    else:
        out = V.generator(params, cfg, mel, fuse_tail=False, valid_len=t)
    return out[:, : V.output_length(cfg, t)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoint_file", required=True, help=".npz or torch g_<step>")
    p.add_argument("--config", default=None)
    p.add_argument("--input_wavs_dir", default=None)
    p.add_argument("--input_mels_dir", default=None)
    p.add_argument("--output_dir", default="generated_files")
    p.add_argument("--metrics_csv", default=None)
    p.add_argument("--fuse_tail", action="store_true",
                   help="vocode through the fused stage / tail kernels (static length: the last ~0.3 s of "
                        "each wav approximates exact-length inference)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu must be asked for)")
    args = p.parse_args(argv)
    if not (args.input_wavs_dir or args.input_mels_dir):
        p.error("give --input_wavs_dir or --input_mels_dir")
    device = resolve_device(args.device)

    tree, c = load_vocoder(args.checkpoint_file, args.config)
    cfg = V.config_from_json(c)
    sr = cfg.sampling_rate
    mel_cfg = mel_config(c, sr, cfg.num_mels)
    params = params_from_numpy(tree, device)

    os.makedirs(args.output_dir, exist_ok=True)
    rows = []
    if args.input_wavs_dir:
        for f in sorted(glob.glob(os.path.join(args.input_wavs_dir, "*.wav"))):
            wav, _ = load_wav(f, sr=sr)
            mel = mel_spectrogram(torch.from_numpy(wav[None]).to(device), mel_cfg)   # [1, 80, T]
            t0 = time.time()
            out = vocode(params, cfg, mel.transpose(1, 2), args.fuse_tail)[0].cpu().numpy()
            wall = time.time() - t0
            name = os.path.basename(f).replace(".wav", "_generated.wav")
            save_wav(os.path.join(args.output_dir, name), out, sr)
            n = min(len(wav), len(out))
            mel_out = mel_spectrogram(torch.from_numpy(out[None]).to(device), mel_cfg)[0].T.cpu().numpy()
            rows.append({
                "file": os.path.basename(f),
                "pesq_nb_approx": round(pesq_nb(wav[:n], out[:n], sr), 4),
                "si_snr": round(si_sdr(wav[:n], out[:n]), 3),
                "stoi": round(stoi(wav[:n], out[:n], sr), 4),
                "estoi": round(estoi(wav[:n], out[:n], sr), 4),
                "mcd_db": round(mcd(mel[0].T.cpu().numpy(), mel_out), 4),
                "rtf": round(wall / (len(out) / sr), 4),
            })
            print(rows[-1], flush=True)
    else:
        for f in sorted(glob.glob(os.path.join(args.input_mels_dir, "*.npy"))):
            mel = np.load(f)
            if mel.shape[0] != cfg.num_mels:
                mel = mel.T
            out = vocode(params, cfg, torch.from_numpy(np.ascontiguousarray(mel.T[None], np.float32)).to(device),
                         args.fuse_tail)[0].cpu().numpy()
            name = os.path.basename(f).replace(".npy", "_generated_e2e.wav")
            save_wav(os.path.join(args.output_dir, name), out, sr)
            print("wrote", name, flush=True)

    if rows:
        means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0] if k != "file"}
        print("mean:", json.dumps(means), flush=True)
        if args.metrics_csv:
            with open(args.metrics_csv, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                w.writerows(rows)


if __name__ == "__main__":
    main()

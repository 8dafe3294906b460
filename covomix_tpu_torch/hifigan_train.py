"""HiFi-GAN vocoder training on one device (the port of hifigan_train.py,
itself a port of hifi-gan/train.py).

    python -m covomix_tpu_torch.hifigan_train --input_wavs_dir wavs/ --config config_covomix.json \\
        --checkpoint_path cp_hifigan [--input_mels_dir mels/] [--bf16] [--device cuda]

The same config JSON (config_covomix.json schema), dataset conventions
(random segment_size crops, the mels computed in the step, or fine-tuning on
precomputed mels with aligned crops) and checkpoints (`step_XXXXXXXX/`
train state with auto-resume from the newest, `g_XXXXXXXX.npz` generators
with the `kind: vocoder` sidecar that hifigan_inference reads). `--init_g` /
`--init_do` start from a reference `g_` / `do_` torch checkpoint or a
converted `.npz` with fresh optimizer moments. One stdout JSON line per
`--stdout_interval` steps and per validation. `--dp N > 1` trains the batch
over N ranks, one process per device (parallel/multihost.spawn): the batch
must divide by N, each rank keeps its rows of the batch the one-device
sampler draws, and rank 0 alone validates, logs and writes checkpoints."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import random
import time

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import MelConfig, load_wav, mel_spectrogram
from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.checkpoint import torch_convert as tc
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.data.prefetch import PrefetchSampler, device_transfer
from covomix_tpu_torch.models import vocoder as V
from covomix_tpu_torch.parallel import multihost as MH, train_step as TS
from covomix_tpu_torch.parallel.mesh import make_mesh
from covomix_tpu_torch.train.gan import GanConfig, export_generator, init_gan_state, make_gan_state, make_gan_step
from covomix_tpu_torch.util.logging_utils import MetricsLogger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input_wavs_dir", required=True)
    p.add_argument("--input_validation_dir", default=None, help="held-out wavs for mel-L1 validation")
    p.add_argument("--validation_interval", type=int, default=1000)
    p.add_argument("--input_mels_dir", default=None, help="fine-tuning: precomputed mels")
    p.add_argument("--checkpoint_path", default="cp_hifigan")
    p.add_argument("--config", default="config_covomix.json")
    p.add_argument("--training_steps", type=int, default=400000)
    p.add_argument("--stdout_interval", type=int, default=50)
    p.add_argument("--checkpoint_interval", type=int, default=1000)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--dp", type=int, default=0, help="data-parallel devices, one process each (0 = one device)")
    p.add_argument("--num_workers", type=int, default=2, help="prefetch threads (DataLoader num_workers)")
    p.add_argument("--bf16", action="store_true", help="the generator in bf16 (the discriminators stay f32)")
    p.add_argument("--init_g", default=None,
                   help="initialize the generator from a reference g_<step> torch checkpoint (converted to "
                        "the (v, g) training form) or a parametrized .npz")
    p.add_argument("--init_do", default=None,
                   help="initialize MPD / MSD from a reference do_<step> torch checkpoint or a converted "
                        "hifigan_discriminators .npz (optimizer moments start fresh)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu must be asked for)")
    return p


def make_sampler(h: dict, files: list, input_mels_dir: str | None):
    """sample_batch(seed) -> {'audio' [B, segment]} (+ 'mel' [B, frames, M]
    when fine-tuning): MelDataset (hifi-gan/meldataset.py:85-169). From
    scratch: a random segment_size crop of a wav normalized to peak 0.95 (the
    mels are computed in the step). Fine-tuning: the predicted mel from
    `input_mels_dir` and the wav cropped aligned, the crop clamped by both."""
    sr, seg, hop, batch_size = h["sampling_rate"], h["segment_size"], h["hop_size"], h["batch_size"]
    frames_per_seg = -(-seg // hop)   # ceil (meldataset.py:146)

    def sample_batch(seed):
        rng = random.Random(seed)
        audios, mels = [], []
        for _ in range(batch_size):
            f = rng.choice(files)
            wav, _ = load_wav(f, sr=sr)
            if input_mels_dir is not None:
                mel = np.load(mel_path(input_mels_dir, f))   # [M, T] or [T, M]
                if mel.shape[0] == h["num_mels"] and mel.shape[-1] != h["num_mels"]:
                    mel = mel.T
                if len(wav) >= seg and mel.shape[0] > frames_per_seg + 1:
                    # a bucket-padded mel can outrun the audio: clamp the crop by the wav too
                    ms_max = min(mel.shape[0] - frames_per_seg - 1, len(wav) // hop - frames_per_seg)
                    ms = rng.randint(0, max(ms_max, 0)) if ms_max > 0 else 0
                    mel = mel[ms: ms + frames_per_seg]
                    wav = wav[ms * hop: (ms + frames_per_seg) * hop]
                    wav = np.pad(wav, (0, frames_per_seg * hop - len(wav)))
                else:
                    mel = (np.pad(mel, ((0, frames_per_seg - mel.shape[0]), (0, 0)), constant_values=-15.0)
                           if mel.shape[0] < frames_per_seg else mel[:frames_per_seg])
                    wav = np.pad(wav, (0, max(0, frames_per_seg * hop - len(wav))))[: frames_per_seg * hop]
                mels.append(mel.astype(np.float32))
            else:
                wav = wav / max(np.abs(wav).max(), 1e-9) * 0.95
                if len(wav) >= seg:
                    start = rng.randint(0, len(wav) - seg)
                    wav = wav[start: start + seg]
                else:
                    wav = np.pad(wav, (0, seg - len(wav)))
            audios.append(wav.astype(np.float32))
        batch = {"audio": np.stack(audios)}
        if input_mels_dir is not None:
            batch["mel"] = np.stack(mels)
        return batch

    return sample_batch


def configs(h: dict, n_files: int):
    """(vocoder, input mel, mel-loss and GAN configs) of a config JSON's
    dict, for a run over `n_files` training files."""
    sr = h["sampling_rate"]
    mel_cfg = MelConfig(sr, h["n_fft"], h["num_mels"], h["hop_size"], h["win_size"], h["fmin"], h["fmax"])
    fmax_loss = h.get("fmax_for_loss") or sr / 2
    mel_loss_cfg = MelConfig(sr, h["n_fft"], h["num_mels"], h["hop_size"], h["win_size"], h["fmin"], fmax_loss)
    gan_cfg = GanConfig(learning_rate=h["learning_rate"], adam_b1=h["adam_b1"], adam_b2=h["adam_b2"],
                        lr_decay=h["lr_decay"], steps_per_epoch=max(1, n_files // h["batch_size"]),
                        segment_size=h["segment_size"])
    return V.config_from_json(h), mel_cfg, mel_loss_cfg, gan_cfg


def mel_path(input_mels_dir: str, wav_path: str) -> str:
    return os.path.join(input_mels_dir, os.path.splitext(os.path.basename(wav_path))[0] + ".npy")


def initial_state(args, h, voc_cfg, gan_cfg, device):
    """Seeded random weights (drawn on the CPU, so every device starts from
    the same ones), or the --init_g / --init_do checkpoints with fresh
    optimizer moments."""
    state = init_gan_state(torch.Generator().manual_seed(args.seed), voc_cfg, gan_cfg, device=device)
    if not (args.init_g or args.init_do):
        return state
    gen_p, mpd_p, msd_p = state.gen_params, state.mpd_params, state.msd_params
    if args.init_g:
        tree = (cio.load_params(args.init_g) if args.init_g.endswith(".npz")
                else tc.convert_hifigan_ckpt(args.init_g, h, parametrized=True))
        gen_p = params_from_numpy(tree, device)
        print(f"generator initialized from {args.init_g}")
    if args.init_do:
        if args.init_do.endswith(".npz"):
            d = cio.load_params(args.init_do)
            mpd_p, msd_p = d["mpd"], d["msd"]
        else:
            mpd_p, msd_p = tc.convert_hifigan_discriminators(tc.load_torch_file(args.init_do))
        mpd_p, msd_p = params_from_numpy(mpd_p, device), params_from_numpy(msd_p, device)
        print(f"discriminators initialized from {args.init_do}")
    return make_gan_state(gen_p, mpd_p, msd_p, gan_cfg)


def main(argv=None):
    """Train; returns the final train.gan.GanState (for callers in process),
    or None after a `--dp N > 1` run, whose ranks run in processes of their
    own."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.dp > 1:
        with open(args.config) as f:
            batch_size = json.load(f)["batch_size"]
        if batch_size % args.dp:
            raise AssertionError(f"batch {batch_size} not divisible by dp={args.dp}")
        mesh = make_mesh(args.dp, device)
        print(f"dp mesh over {mesh.dp} devices")
        MH.spawn(_rank_main, mesh.dp, args, device=device)
        return None
    return _train(args, device)


def _rank_main(args) -> None:
    """One rank of a `--dp N` run (multihost.spawn); rank 0 alone prints."""
    mesh = make_mesh(args.dp, args.device)
    with contextlib.ExitStack() as stack:
        if mesh.rank:
            stack.enter_context(contextlib.redirect_stdout(stack.enter_context(open(os.devnull, "w"))))
        _train(args, mesh.device, mesh)


def _train(args, device, mesh=None):
    """The run on `device`; with `mesh`, as one rank of it: the state is
    rank 0's, the rank keeps its rows of every batch the one-device sampler
    draws (JAX's P('dp') split), D's and G's gradients are averaged over the
    ranks, and rank 0 alone validates, logs and writes checkpoints."""
    primary = mesh is None or mesh.rank == 0
    with open(args.config) as f:
        h = json.load(f)
    sr = h["sampling_rate"]

    files = sorted(glob.glob(os.path.join(args.input_wavs_dir, "**", "*.wav"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no wavs under {args.input_wavs_dir}")
    print(f"{len(files)} training wavs")
    if args.input_mels_dir is not None:
        files = [f for f in files if os.path.isfile(mel_path(args.input_mels_dir, f))]
        if not files:
            raise FileNotFoundError(f"no wavs with matching mels in {args.input_mels_dir}")
        print(f"fine-tuning on {len(files)} wav/mel pairs")

    seg = h["segment_size"]
    voc_cfg, mel_cfg, mel_loss_cfg, gan_cfg = configs(h, len(files))
    state = initial_state(args, h, voc_cfg, gan_cfg, device)
    step_fn = make_gan_step(voc_cfg, mel_cfg, mel_loss_cfg, gan_cfg,
                            dtype=torch.bfloat16 if args.bf16 else torch.float32, mesh=mesh)

    os.makedirs(args.checkpoint_path, exist_ok=True)
    start = cio.latest_step(args.checkpoint_path) or 0
    if start:
        state = cio.load_train_state(args.checkpoint_path, start, state)
        print(f"resumed from step {start}")
    if mesh is not None:
        TS.replicate_state(mesh, state)

    # validation: copy-synthesis mel L1 on up to 8 held-out wavs, the first
    # one's audio to TensorBoard (hifi-gan/train.py:192-225)
    logger = MetricsLogger(args.checkpoint_path) if primary else None
    val_files = sorted(glob.glob(os.path.join(args.input_validation_dir, "**", "*.wav"),
                                 recursive=True))[:8] if args.input_validation_dir else []

    @torch.no_grad()
    def validate(step_i):
        gen = export_generator(state, gan_cfg)
        errs = []
        for vi, f in enumerate(val_files):
            wav, _ = load_wav(f, sr=sr)
            wav = wav[:seg] if len(wav) >= seg else np.pad(wav, (0, seg - len(wav)))
            y = torch.from_numpy(np.ascontiguousarray(wav[None], np.float32)).to(device)
            mel = mel_spectrogram(y, mel_cfg).transpose(1, 2)
            y_hat = V.generator(gen, voc_cfg, mel, fuse_tail=False)[:, : len(wav)]
            errs.append(float(torch.mean(torch.abs(mel_spectrogram(y_hat, mel_loss_cfg)
                                                    - mel_spectrogram(y, mel_loss_cfg)))))
            if vi == 0:
                logger.log_audio(step_i, "validation/sample", y_hat[0].cpu().numpy(), sr)
        val = float(np.mean(errs)) if errs else float("nan")
        logger.log(step_i, {"validation_mel_l1": val})
        print(json.dumps({"step": step_i, "validation_mel_l1": round(val, 4)}), flush=True)

    to_device = device_transfer(device)
    transfer = to_device if mesh is None else (lambda batch: to_device(TS.shard_batch(mesh, batch)))
    loader = PrefetchSampler(make_sampler(h, files, args.input_mels_dir), num_workers=max(1, args.num_workers),
                             buffer_size=2, seed=args.seed, transfer=transfer)
    try:
        t0 = time.time()
        for step_i in range(start, args.training_steps):
            metrics = step_fn(state, next(loader))
            if not primary:
                continue
            if (step_i + 1) % args.stdout_interval == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                print(json.dumps({"step": step_i + 1, **m,
                                  "sps": round(args.stdout_interval / (time.time() - t0), 2)}), flush=True)
                t0 = time.time()
            if val_files and (step_i + 1) % args.validation_interval == 0:
                validate(step_i + 1)
            if (step_i + 1) % args.checkpoint_interval == 0:
                cio.save_train_state(args.checkpoint_path, state, step_i + 1)
                cio.save_params(os.path.join(args.checkpoint_path, f"g_{step_i + 1:08d}.npz"),
                                export_generator(state, gan_cfg),
                                meta={"kind": "vocoder", "config": dataclasses.asdict(voc_cfg)})
    finally:
        loader.close()
        if logger is not None:
            logger.close()
    return state


if __name__ == "__main__":
    main()

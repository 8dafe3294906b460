"""Convert the reference's released PyTorch checkpoints to `.npz` + `.json`
(the port of convert_checkpoint.py; the files it writes are the ones either
package's `checkpoint.io.load_params` reads).

    python -m covomix_tpu_torch.convert_checkpoint lightning model.ckpt out.npz [--no-ema]
    python -m covomix_tpu_torch.convert_checkpoint hifigan g_00400000 out.npz [--config vocoder_config.json]
    python -m covomix_tpu_torch.convert_checkpoint hifigan do_00400000 out.npz
    python -m covomix_tpu_torch.convert_checkpoint hubert hubert_fisher.pt out.npz --km hubert_fisher_km_500.bin

Kinds: a Lightning `.ckpt` (acoustic or T2S, EMA weights unless --no-ema;
the config from its hyper_parameters), a HiFi-GAN generator `g_<step>`
(weight norm folded; the config from --config or the vocoder_config.json
beside it) or discriminators `do_<step>` (the (v, g) / spectral-norm training
form), a fairseq HuBERT `.pt` with its k-means `.bin` (which needs joblib
and scikit-learn). Runs on the CPU; it reads and writes files only."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.checkpoint import torch_convert as tc
from covomix_tpu_torch.models import vocoder as V


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("kind", choices=["lightning", "hifigan", "hubert"])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--no-ema", action="store_true", help="use raw (non-EMA) weights")
    p.add_argument("--config", default=None, help="vocoder_config.json for hifigan")
    p.add_argument("--km", default=None, help="k-means .bin for hubert")
    args = p.parse_args(argv)

    if args.kind == "lightning":
        params, hparams = tc.convert_lightning_ckpt(args.src, use_ema=not args.no_ema)
        kind = "t2s" if hparams.get("text2semantic") else "acoustic"
        cio.save_params(args.dst, params, meta={"kind": kind, "config": tc.cfg_kwargs_from_hparams(hparams),
                                                "source": args.src, "ema": not args.no_ema})
    elif args.kind == "hifigan":
        h = {}
        cfg_file = args.config or os.path.join(os.path.dirname(args.src), "vocoder_config.json")
        if os.path.isfile(cfg_file):
            with open(cfg_file) as f:
                h = json.load(f)
        ckpt = tc.load_torch_file(args.src)
        if "mpd" in ckpt and "msd" in ckpt:
            mpd, msd = tc.convert_hifigan_discriminators(ckpt)
            cio.save_params(args.dst, {"mpd": mpd, "msd": msd},
                            meta={"kind": "hifigan_discriminators", "source": args.src,
                                  "steps": int(ckpt.get("steps", 0))})
            print(f"converted MPD+MSD (do_ checkpoint, step {ckpt.get('steps', '?')}) -> {args.dst}")
            return
        sd = ckpt["generator"] if "generator" in ckpt else ckpt
        params = tc.convert_hifigan_generator(sd, num_ups=len(h.get("upsample_rates", [5, 4, 4, 2])),
                                              num_kernels=len(h.get("resblock_kernel_sizes", [3, 7, 11])))
        cfg = json.loads(json.dumps(dataclasses.asdict(V.config_from_json(h))))
        cio.save_params(args.dst, params, meta={"kind": "vocoder", "config": cfg, "source": args.src})
    else:
        params = tc.convert_hubert_ckpt(args.src, args.km)
        cio.save_params(args.dst, params, meta={"kind": "hubert", "config": {}, "source": args.src, "km": args.km})
    print(f"wrote {args.dst} (+ .json)")


if __name__ == "__main__":
    main()

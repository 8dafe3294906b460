"""Metrics logging (the port's copy of covomix_tpu/util/logging_utils.py):
JSONL always; TensorBoard event files when `torch.utils.tensorboard` imports;
a W&B run when asked for and available. The event files are written through
TensorBoard's own file layer: TensorFlow, where it is installed, is not
imported for them (a slow import that nothing else here needs)."""

from __future__ import annotations

import json
import os
import sys
import time
import types
from typing import Optional

import numpy as np


class MetricsLogger:
    def __init__(self, run_dir: str, tensorboard: bool = True, wandb: bool = False,
                 wandb_project: str = "covomix", wandb_run: Optional[str] = None):
        os.makedirs(run_dir, exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            # TensorBoard's "no TensorFlow" marker: `tensorboard.compat.tf` then
            # resolves to its bundled stub (gfile on the local file system)
            sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:    # the tensorboard package is not installed
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=os.path.join(run_dir, "tb"))
        # W&B sink unless --no_wandb; it needs the wandb package and the
        # network. When either is missing the logger says so once and the
        # offline sinks carry the run.
        self._wandb = None
        if wandb:
            try:
                import wandb as _wandb

                self._wandb = _wandb.init(project=wandb_project, name=wandb_run, dir=run_dir, resume="allow")
            except Exception as e:  # noqa: BLE001 - missing package or no network: an optional sink
                print(f"note: W&B sink unavailable ({type(e).__name__}); "
                      f"logging to JSONL+TensorBoard in {run_dir}")

    def log(self, step: int, metrics: dict, prefix: str = "") -> None:
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                rec[key] = v
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k in ("step", "time") or not isinstance(v, float):
                    continue
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "time" and isinstance(v, float)}, step=step)

    def log_audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        """A waveform to TensorBoard (no other sink takes audio)."""
        if self._tb is not None:
            self._tb.add_audio(tag, np.asarray(wav).reshape(1, -1), step, sample_rate=sample_rate)

    def close(self) -> None:
        if not self._jsonl.closed:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

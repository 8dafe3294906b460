"""Legacy `Specs` speech-enhancement dataset (port of
covomix_tpu/data/specs_legacy.py).

Clean / noisy wav pairs under `<data_dir>/<subset>/s1` and
`<data_dir>/<subset>/<train_noisy_data>` (default `mix_both`; `mix_single`
when only_enhancement == "yes"), cropped or centre-padded to a fixed frame
budget, peak-normalized, and returned as a pair of transformed complex
STFTs (complex64 tensors on `device`). No CoVoMix synthesis path consumes it.

Also hosts `remove_unwanted_backchannels`."""

from __future__ import annotations

from glob import glob
from os.path import join

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio.spec import spec_fwd, stft_complex
from covomix_tpu_torch.audio.wav import load_wav


class Specs:
    """`stft_kwargs` must carry n_fft / hop_length / center (True) / window
    (a window type string, 'hann' or 'sqrthann'). `spec_transform` defaults
    to `spec_fwd` with its defaults; any callable spec -> spec overrides it.
    The shuffle crop's start is drawn from `np.random`. `device`: where the
    STFTs run and the spectra live (default cuda)."""

    def __init__(self, data_dir, subset, dummy, shuffle_spec, num_frames,
                 format="default", normalize="noisy", spec_transform=None,
                 only_enhancement="no", stft_kwargs=None,
                 train_noisy_data="mix_both", device=None, **ignored_kwargs):
        if format != "default":
            raise NotImplementedError(f"Directory format {format} unknown!")
        self.clean_files = sorted(glob(join(data_dir, subset) + "/s1/*.wav"))
        noisy_dir = "mix_single" if only_enhancement == "yes" else train_noisy_data
        self.noisy_files = sorted(glob(join(data_dir, subset) + f"/{noisy_dir}/*.wav"))

        self.dummy = dummy
        self.num_frames = num_frames
        self.shuffle_spec = shuffle_spec
        self.normalize = normalize
        self.spec_transform = spec_transform if spec_transform is not None else spec_fwd

        stft_kwargs = stft_kwargs or {}
        required = ("n_fft", "hop_length", "center", "window")
        assert all(k in stft_kwargs for k in required), "misconfigured STFT kwargs"
        assert stft_kwargs["center"] is True, "'center' must be True for current implementation"
        self.n_fft = stft_kwargs["n_fft"]
        self.hop_length = stft_kwargs["hop_length"]
        self.window_type = stft_kwargs["window"]
        self.device = resolve_device(device)

    def __getitem__(self, i):
        x, _ = load_wav(self.clean_files[i])
        y, _ = load_wav(self.noisy_files[i])

        # crop to (num_frames - 1) * hop samples (the center=True count), or
        # centre-pad a short file
        target_len = (self.num_frames - 1) * self.hop_length
        current_len = x.shape[-1]
        pad = max(target_len - current_len, 0)
        if pad == 0:
            if self.shuffle_spec:
                start = int(np.random.uniform(0, current_len - target_len))
            else:
                start = (current_len - target_len) // 2
            x = x[..., start: start + target_len]
            y = y[..., start: start + target_len]
        else:
            width = [(0, 0)] * (x.ndim - 1) + [(pad // 2, pad // 2 + pad % 2)]
            x = np.pad(x, width)
            y = np.pad(y, width)

        if self.normalize == "noisy":
            normfac = np.abs(y).max()
        elif self.normalize == "clean":
            normfac = np.abs(x).max()
        else:  # "not"
            normfac = 1.0
        x = x / normfac
        y = y / normfac

        X = stft_complex(torch.as_tensor(x, device=self.device), self.n_fft, self.hop_length, self.window_type)
        Y = stft_complex(torch.as_tensor(y, device=self.device), self.n_fft, self.hop_length, self.window_type)
        return self.spec_transform(X), self.spec_transform(Y)

    def __len__(self):
        if self.dummy:  # a debugging shrink
            return int(len(self.clean_files) / 150)
        return len(self.clean_files)


def remove_unwanted_backchannels(sequence: str) -> str:
    """Drop the '[backchannel]' / '[partialoverlap]' tokens that do not
    directly follow '[spkchange]'."""
    parts = sequence.split()
    result = []
    for i, part in enumerate(parts):
        if part in ("[backchannel]", "[partialoverlap]"):
            if i == 0 or parts[i - 1] != "[spkchange]":
                continue
        result.append(part)
    return " ".join(result)

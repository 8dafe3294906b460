from covomix_tpu_torch.audio.mel import (MelConfig, mel_filterbank, mel_frames_for_samples, mel_spectrogram,
                                         stft_magnitude)
from covomix_tpu_torch.audio.wav import load_wav, resample, save_wav

__all__ = ["MelConfig", "mel_spectrogram", "mel_filterbank", "mel_frames_for_samples", "stft_magnitude",
           "load_wav", "save_wav", "resample"]

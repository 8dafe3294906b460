from covomix_tpu_torch.audio.mel import (MelConfig, log_mel_floor, mel_filterbank, mel_frames_for_samples,
                                         mel_spectrogram, stft_magnitude)
from covomix_tpu_torch.audio.spec import get_window, istft, spec_back, spec_fwd, stft_complex
from covomix_tpu_torch.audio.wav import load_wav, resample, save_wav

__all__ = ["MelConfig", "mel_spectrogram", "mel_filterbank", "log_mel_floor", "mel_frames_for_samples",
           "stft_magnitude", "load_wav", "save_wav", "resample", "get_window", "istft", "spec_back", "spec_fwd",
           "stft_complex"]

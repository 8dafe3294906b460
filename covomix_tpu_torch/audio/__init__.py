from covomix_tpu_torch.audio.mel import MelConfig, mel_filterbank, mel_spectrogram
from covomix_tpu_torch.audio.wav import load_wav, resample, save_wav

__all__ = ["MelConfig", "mel_spectrogram", "mel_filterbank", "load_wav", "save_wav", "resample"]

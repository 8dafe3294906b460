"""End-to-end per-file synthesis: text + prompts -> waveform (port of
covomix_tpu/pipeline.py).

  * prompt prep: `.hubert_code.npy` (string array -> int) + mel of the
    sibling `.wav` (or its `.mel.npy` cache), equal length, capped at 400
    frames (8 s at 20 ms)
  * text cleanup: remove_punctuation + lower
  * covosingle: prompt tokens ‖ T2S tokens, clamp <= 501, cond mel zeros past
    the prompt, flow sample at cond_scale 0.7, trim to the generated region,
    vocode
  * covosinx: stream B = silence token 157
  * covomix: CoMix dual-stream decode; VoMix 160-d cond
  * dialogue variants with `[spkchange]` turn splitting and `_1`/`_2` prompts

Sequence lengths are bucketed as in the JAX package (flow and vocoder to
multiples of `bucket`, text ids to multiples of 16), padded with the
training-time pad values (mel -15 / token 501), and outputs are trimmed to
the true length. The flow sampler gets a scalar `valid_len`, so its attention
runs on the flash kernel on the card; the vocoder gets one unless
`fuse_tail`, which lets the generator run the fused stage and tail kernels.

Randomness: every method that samples takes one `torch.Generator` and draws
from it in the order in which the JAX package splits its key (T2S decode,
then the flow sampler's y0; turn by turn in the per-turn dialogue modes)."""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from covomix_tpu_torch import resolve_device
from covomix_tpu_torch.audio import MelConfig, load_wav, mel_spectrogram
from covomix_tpu_torch.checkpoint import io as cio
from covomix_tpu_torch.checkpoint import torch_convert as tc
from covomix_tpu_torch.checkpoint.io import params_from_numpy
from covomix_tpu_torch.data.tokenizer import load_covomix_tokenizer, remove_punctuation
from covomix_tpu_torch.models import acoustic as A
from covomix_tpu_torch.models import text2semantic as T
from covomix_tpu_torch.models import vocoder as V
from covomix_tpu_torch.util.misc import round_up

SILENCE_TOKEN = 157          # silence unit id
TOKEN_CLAMP = 501            # clamp ceiling incl. EOS
PROMPT_MAX_FRAMES = 400      # 8 s at 20 ms hop
MEL_PAD = -15.0              # collate pad value
PARALLEL_ITEM = "ROADMAP.md 'Modules to port': Parallelism"


def _tupled(v):
    """JSON lists -> tuples (nested), so frozen configs stay hashable."""
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def load_checkpoint(path: str, cfg_cls):
    """(numpy parameter tree, config) of a checkpoint in any of the formats
    the JAX generation CLIs read (their `load_any`):
      * `.npz` whose `.json` sidecar carries the model config under "config";
      * a Lightning `.ckpt` of the T2S or acoustic model (`cfg_cls` says
        which), EMA weights, the config from its hyper_parameters;
      * a HiFi-GAN `g_<step>` (`cfg_cls` VocoderConfig), weight norm folded,
        the config from the `vocoder_config.json` beside it (defaults
        without one)."""
    if path.endswith(".npz"):
        params = cio.load_params(path)
        meta = cio.load_meta(path)
        fields = {f.name for f in dataclasses.fields(cfg_cls)}
        cfg = cfg_cls(**{k: _tupled(v) for k, v in meta.get("config", {}).items() if k in fields})
        return params, cfg
    if cfg_cls is V.VocoderConfig:
        cfg_file = os.path.join(os.path.dirname(path), "vocoder_config.json")
        h = {}
        if os.path.isfile(cfg_file):
            with open(cfg_file) as f:
                h = json.load(f)
        return tc.convert_hifigan_ckpt(path, h), V.config_from_json(h)
    kind = "t2s" if cfg_cls is T.T2SConfig else "acoustic"
    params, hparams = tc.convert_lightning_ckpt(path)
    return params, cfg_cls(**tc.cfg_kwargs_from_hparams(hparams, kind=kind))


def extract_mel(wav_path: str, mel_cfg: MelConfig = MelConfig(), device=None,
                channel: Optional[int] = None) -> np.ndarray:
    """[T, 80] mel of a wav, computed on `device` (None -> cuda); a sibling
    `.mel.npy` cache ([80, T]) wins when present. `channel` picks one channel
    of a multi-channel wav (default: the mean of the channels)."""
    device = resolve_device(device)
    cache = wav_path.replace(".wav", ".mel.npy")
    if os.path.exists(cache):
        return np.load(cache).T
    wav, _ = load_wav(wav_path, sr=mel_cfg.sample_rate, channel=channel)
    y = torch.as_tensor(wav, dtype=torch.float32, device=device)[None]
    return mel_spectrogram(y, mel_cfg)[0].cpu().numpy().T


def prepare_prompt(hubert_code_path: str, mel_cfg: MelConfig = MelConfig(),
                   device=None) -> Tuple[np.ndarray, np.ndarray]:
    """(semantic tokens [T], mel [T, 80]) of equal length, capped at 400
    frames; the mel is computed on `device` (None -> cuda). Code files may
    store strings; they are cast to int."""
    codes = np.load(hubert_code_path).astype(int)
    mel = extract_mel(hubert_code_path.replace(".hubert_code.npy", ".wav"), mel_cfg, device)
    n = min(len(codes), len(mel), PROMPT_MAX_FRAMES)
    return codes[:n], mel[:n]


def clean_text(text: str) -> str:
    return remove_punctuation(text).lower()


@dataclasses.dataclass
class Synthesizer:
    """Holds the three models' parameters (carried onto `device` once) and
    runs the per-file monologue / dialogue modes."""

    t2s_params: dict
    t2s_cfg: T.T2SConfig
    acoustic_params: dict
    acoustic_cfg: A.AcousticConfig
    vocoder_params: dict
    vocoder_cfg: V.VocoderConfig
    tokenizer: object                      # WordPieceTokenizer-compatible
    mel_cfg: MelConfig = MelConfig()
    bucket: int = 128
    t2s_max_length: int = 2048
    cond_scale: float = 0.7                # acoustic CFG
    t2s_cond_scale: float = 1.0            # the CLIs run no T2S CFG
    temperature: float = 1.0
    dtype: torch.dtype = torch.float32
    # True: vocode without valid_len, so the generator may run the fused
    # stage and tail kernels (on CUDA, covomix-shaped configs). They are
    # static-length: bucket-pad frames are not re-zeroed, and the last ~16
    # mel frames (~0.3 s) of each wav approximate exact-length vocoding.
    # False (default): exact, valid_len masking.
    fuse_tail: bool = False
    # True: greedy self-speculative T2S decode (generate_speculative: the
    # early-exit head drafts, the full depth verifies; the tokens of greedy
    # generate). Needs a checkpoint trained with target_early_exit_layer > 0,
    # for two_output also the stream-2 draft head, which the released
    # checkpoints lack. The generator, temperature and T2S CFG do not apply.
    speculative: bool = False
    device: Optional[str] = None           # None -> cuda

    def __post_init__(self):
        if self.speculative:
            if self.t2s_cfg.target_early_exit_layer <= 0:
                raise ValueError("--speculative needs a T2S checkpoint trained "
                                 "with an early-exit head (target_early_exit_layer > 0)")
            if self.t2s_cfg.two_output and "to_logits2" not in self.t2s_params.get("early_exit", {}):
                raise ValueError("--speculative on a two-stream (CoMix) checkpoint needs "
                                 "the stream-2 draft head ('early_exit/to_logits2', trained "
                                 "by this framework); reference checkpoints carry only the "
                                 "stream-1 head")
        self.device = resolve_device(self.device)
        self.t2s_params = params_from_numpy(self.t2s_params, self.device)
        self.acoustic_params = params_from_numpy(self.acoustic_params, self.device)
        self.vocoder_params = params_from_numpy(self.vocoder_params, self.device)
        if self.speculative:
            spec = functools.partial(T.generate_speculative, cfg=self.t2s_cfg, max_length=self.t2s_max_length,
                                     dtype=self.dtype)
            self._gen_fn = lambda params, generator, source_ids: spec(params, source_ids=source_ids)
        else:
            self._gen_fn = functools.partial(T.generate, cfg=self.t2s_cfg, max_length=self.t2s_max_length,
                                             temperature=self.temperature, cond_scale=self.t2s_cond_scale,
                                             dtype=self.dtype)
        self._sample_fn = functools.partial(A.sample, cfg=self.acoustic_cfg, cond_scale=self.cond_scale,
                                            dtype=self.dtype)
        # fuse_tail=None: the generator's auto dispatch (fused kernels on CUDA
        # for covomix-shaped configs); valid_len, when given, forces unfused
        self._voc_fn = functools.partial(V.generator, cfg=self.vocoder_cfg, dtype=self.dtype)

    # ---- prompt preparation ------------------------------------------------

    def extract_mel(self, wav_path: str, channel: Optional[int] = None) -> np.ndarray:
        return extract_mel(wav_path, self.mel_cfg, self.device, channel)

    def prepare_prompt(self, hubert_code_path: str) -> Tuple[np.ndarray, np.ndarray]:
        return prepare_prompt(hubert_code_path, self.mel_cfg, self.device)

    # ---- stages ------------------------------------------------------------

    def _encode_bucketed(self, text: str) -> np.ndarray:
        """Token ids padded to a multiple of 16 (pad 0 = BERT [PAD]; the
        decode's source mask drops the padding)."""
        ids, _ = self.tokenizer.batch_encode([text])
        s = round_up(max(ids.shape[1], 1), 16)
        return np.pad(np.asarray(ids), ((0, 0), (0, s - ids.shape[1])))

    def _decode(self, text: str, generator):
        ids = torch.as_tensor(self._encode_bucketed(text), dtype=torch.int32, device=self.device)
        return self._gen_fn(self.t2s_params, generator=generator, source_ids=ids)

    def text_to_tokens(self, text: str, generator) -> np.ndarray:
        """T2S decode; the non-pad token ids."""
        toks = self._decode(text, generator).tokens[0].cpu().numpy()
        return toks[toks != self.t2s_cfg.semantic_pad_id]

    def text_to_tokens_2stream(self, text: str, generator) -> Tuple[np.ndarray, np.ndarray]:
        """CoMix decode: both streams, cut to the shorter one's length."""
        gen = self._decode(text, generator)
        pad = self.t2s_cfg.semantic_pad_id
        t1 = gen.tokens[0].cpu().numpy()
        t1 = t1[t1 != pad]
        t2 = gen.tokens2[0].cpu().numpy()
        t2 = t2[t2 != pad]
        n = min(len(t1), len(t2))
        return t1[:n], t2[:n]

    def flow_sample(self, phoneme_ids: np.ndarray, cond: np.ndarray, generator,
                    noise=None) -> np.ndarray:
        """Bucket-padded flow-matching sample; returns [T, 80] trimmed. Pad
        frames are kept out of attention by a scalar `valid_len`. `noise`
        ([1, bucketed T, 80]) overrides the y0 draw."""
        t = len(phoneme_ids)
        tb = max(self.bucket, round_up(t, self.bucket))
        ph = np.full((tb,) + phoneme_ids.shape[1:], TOKEN_CLAMP, np.int32)
        ph[:t] = phoneme_ids
        c = np.zeros((tb, cond.shape[1]), np.float32)
        c[:t] = cond
        dev = self.device
        mel = self._sample_fn(self.acoustic_params, generator=generator,
                              phoneme_ids=torch.as_tensor(ph[None], device=dev),
                              cond=torch.as_tensor(c[None], device=dev), valid_len=t,
                              noise=None if noise is None else torch.as_tensor(noise, device=dev))
        return mel[0, :t].cpu().numpy()

    def vocode(self, mel: np.ndarray) -> np.ndarray:
        """[T, 80] mel -> waveform trimmed to T * hop. The mel is padded to the
        bucket with MEL_PAD; `valid_len` re-zeroes the pad frames after every
        generator conv unless `fuse_tail`."""
        t = len(mel)
        tb = max(self.bucket, round_up(t, self.bucket))
        m = np.full((tb, mel.shape[1]), MEL_PAD, np.float32)
        m[:t] = mel
        m = torch.as_tensor(m[None], device=self.device)
        wav = self._voc_fn(self.vocoder_params, mel=m, valid_len=None if self.fuse_tail else t)
        return wav[0, : t * self.mel_cfg.hop_size].cpu().numpy()

    def _check_mode(self, mode: str) -> None:
        """Fail fast on a model-variant / mode mismatch."""
        streams = self.acoustic_cfg.n_phoneme_streams
        if mode == "covosingle" and streams != 1:
            raise ValueError(
                f"mode covosingle needs a VoSingle acoustic model (1 phoneme stream); "
                f"got mode={self.acoustic_cfg.mode!r} ({streams} streams)")
        if mode in ("covosinx", "covomix") and streams != 2:
            raise ValueError(
                f"mode {mode} needs a two-stream acoustic model (two_two/two_one); "
                f"got mode={self.acoustic_cfg.mode!r}")
        if mode == "covomix" and not getattr(self.t2s_cfg, "two_output", False):
            raise ValueError("mode covomix needs a CoMix T2S model (two_output=True)")
        if self.acoustic_cfg.mel_dim != self.vocoder_cfg.num_mels:
            raise ValueError(
                f"acoustic model outputs {self.acoustic_cfg.mel_dim}-d mel but the "
                f"vocoder expects {self.vocoder_cfg.num_mels}-d "
                f"(acoustic mode={self.acoustic_cfg.mode!r}: covosinx/covomix "
                f"synthesis needs the two_one mixed-output variant)")

    # ---- modes (monologue) -------------------------------------------------

    def synthesize_turn(self, text: str, sem_prompt: np.ndarray, mel_prompt: np.ndarray,
                        generator) -> np.ndarray:
        """covosingle one-utterance path."""
        pred = self.text_to_tokens(text, generator)
        phone_input = np.clip(np.concatenate([sem_prompt, pred]), None, TOKEN_CLAMP)
        cond = np.zeros((len(phone_input), self.acoustic_cfg.dim_in), np.float32)
        cond[: len(mel_prompt)] = mel_prompt
        mel = self.flow_sample(phone_input.astype(np.int32), cond, generator)
        return self.vocode(mel[len(mel_prompt):])

    def synthesize_two_stream(self, sem_a, sem_b, mel_prompt_2ch: np.ndarray, prompt_len: int,
                              generator) -> np.ndarray:
        """Shared covosinx/covomix acoustic pass: 2-stream phonemes + 160-d
        cond -> mixed mel -> wav."""
        n = max(len(sem_a), len(sem_b))
        sem_a = np.pad(sem_a, (0, n - len(sem_a)), constant_values=SILENCE_TOKEN)
        sem_b = np.pad(sem_b, (0, n - len(sem_b)), constant_values=SILENCE_TOKEN)
        phones = np.clip(np.stack([sem_a, sem_b], axis=-1), None, TOKEN_CLAMP).astype(np.int32)
        cond = np.zeros((n, mel_prompt_2ch.shape[1]), np.float32)
        cond[:prompt_len] = mel_prompt_2ch[:prompt_len]
        mel = self.flow_sample(phones, cond, generator)
        return self.vocode(mel[prompt_len:])

    def monologue(self, mode: str, text: str, prompt_path: str, generator) -> np.ndarray:
        self._check_mode(mode)
        text = clean_text(text)
        sem, mel = self.prepare_prompt(prompt_path)
        if mode == "covosingle":
            return self.synthesize_turn(text, sem, mel, generator)
        prompt_len = len(mel)
        mel2 = np.concatenate([mel, mel], axis=-1)  # the same prompt on both streams
        if mode == "covosinx":
            pred = self.text_to_tokens(text, generator)
            sem_a = np.concatenate([sem, pred])
            sem_b = np.concatenate([sem, np.full(len(pred), SILENCE_TOKEN, pred.dtype)])
        elif mode == "covomix":
            p1, p2 = self.text_to_tokens_2stream(text, generator)
            sem_a = np.concatenate([sem, p1])
            sem_b = np.concatenate([sem, p2])
        else:
            raise ValueError(f"unknown mode {mode}")
        return self.synthesize_two_stream(sem_a, sem_b, mel2, prompt_len, generator)

    # ---- modes (dialogue) --------------------------------------------------

    def dialogue(self, mode: str, text: str, prompt_path_1: str, prompt_path_2: str,
                 generator) -> np.ndarray:
        self._check_mode(mode)
        sem1, mel1 = self.prepare_prompt(prompt_path_1)
        sem2, mel2 = self.prepare_prompt(prompt_path_2)
        if mode == "covosingle":
            # per-turn synthesis alternating prompts, waveform concat
            wavs = []
            for i, turn in enumerate(text.split("[spkchange]")):
                sem, mel = (sem1, mel1) if i % 2 == 0 else (sem2, mel2)
                wavs.append(self.synthesize_turn(clean_text(turn), sem, mel, generator))
            return np.concatenate(wavs) if wavs else np.zeros((0,), np.float32)

        prompt_len = min(len(mel1), len(mel2))
        mel_2ch = np.concatenate([mel1[:prompt_len], mel2[:prompt_len]], axis=-1)
        sem_a, sem_b = sem1[:prompt_len], sem2[:prompt_len]
        if mode == "covosinx":
            # per-turn T2S, tokens routed to alternating streams
            for i, turn in enumerate(text.split("[spkchange]")):
                pred = self.text_to_tokens(clean_text(turn), generator)
                sil = np.full(len(pred), SILENCE_TOKEN, pred.dtype)
                if i % 2 == 0:
                    sem_a, sem_b = np.concatenate([sem_a, pred]), np.concatenate([sem_b, sil])
                else:
                    sem_a, sem_b = np.concatenate([sem_a, sil]), np.concatenate([sem_b, pred])
        elif mode == "covomix":
            # the full script through CoMix once
            p1, p2 = self.text_to_tokens_2stream(clean_text(text), generator)
            sem_a = np.concatenate([sem_a, p1])
            sem_b = np.concatenate([sem_b, p2])
        else:
            raise ValueError(f"unknown mode {mode}")
        return self.synthesize_two_stream(sem_a, sem_b, mel_2ch, prompt_len, generator)


def load_synthesizer(t2s_path: str, acoustic_path: str, vocoder_path: str, *,
                     vocab_path: Optional[str] = None, strict: bool = True, **kwargs) -> Synthesizer:
    """A Synthesizer from three checkpoints in any format `load_checkpoint`
    reads (`.npz` + `.json`, Lightning `.ckpt`, HiFi-GAN `g_<step>`).
    `strict=False` permits the tokenizer's fallback vocab; `mel_cfg` defaults
    to the vocoder's sample rate."""
    t2s_params, t2s_cfg = load_checkpoint(t2s_path, T.T2SConfig)
    ac_params, ac_cfg = load_checkpoint(acoustic_path, A.AcousticConfig)
    voc_params, voc_cfg = load_checkpoint(vocoder_path, V.VocoderConfig)
    tok = load_covomix_tokenizer(vocab_path, strict=strict)
    kwargs.setdefault("mel_cfg", MelConfig(sample_rate=voc_cfg.sampling_rate))
    return Synthesizer(t2s_params, t2s_cfg, ac_params, ac_cfg, voc_params, voc_cfg, tok, **kwargs)

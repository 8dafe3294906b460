"""Dataset pipeline for the CoVoMix training formats (the port's own copy of
covomix_tpu/data/datasets.py, numpy and `random` only).

Formats:
  default                              mel + phone_by_frame, crop 1600
  hubert_fisher                        VoSingle: *.mel.npy + *.hubert_code.npy, crop 800
  hubert_overlap_two_input_two_output  A/B channel mels + 2 token streams
  hubert_overlap_two_input_one_output  VoMix: A/B/mixed mel triplet
  text2semantic                        CoSingle: hubert codes + sibling .txt
  text2semantic_2output                CoMix: 2-stream w/ 40/40/20 augmentation

Collate: mel pad -15, hubert codes pad 501, mask False; batches are padded to
a 64-frame bucket (`collate_acoustic`). T2S batches (`collate_t2s`): token ids
from the tokenizer padded with 0 to a multiple of 16, semantic targets padded
with 501 to a 64 bucket; `collate_t2s_duration` run-length compresses the
targets into (tokens, durations), padded 501 / 0. With the same files and
seed this gives the same items and batches as the JAX package."""

from __future__ import annotations

import glob
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from covomix_tpu_torch.util.misc import round_up

MEL_PAD = -15.0
CODE_PAD = 501
SILENCE_TOKEN = 157


def load_codes(path: str) -> np.ndarray:
    """`.hubert_code.npy` files store string arrays; every consumer casts int."""
    return np.load(path).astype(int)


@dataclass
class CoVoMixDataset:
    """File-list dataset. `base_dir` is scanned for `*.mel.npy` (acoustic
    formats) or `*.hubert_code.npy` (t2s formats)."""

    base_dir: str
    format: str = "hubert_fisher"
    shuffle_spec: bool = True            # random vs centered crop
    random_mask: bool = False
    max_len: int = 800                   # acoustic crop
    t2s_max_len: int = 2048
    dummy: bool = False
    seed: int = 0
    files: List[str] = field(default_factory=list)
    rng: random.Random = field(default_factory=random.Random)

    def __post_init__(self):
        self.rng = random.Random(self.seed)
        if not self.files:
            if self.format.startswith("text2semantic"):
                pattern = "*.hubert_code.npy"
                self.files = sorted(
                    f for f in glob.glob(os.path.join(self.base_dir, "**", pattern), recursive=True)
                    if not f.endswith("_2.hubert_code.npy")
                )
            else:
                self.files = sorted(glob.glob(os.path.join(self.base_dir, "**", "*.mel.npy"), recursive=True))
                if self.format.startswith("hubert_overlap_two_input"):
                    # dialogue corpora carry per-channel -A/-B mels; the items
                    # are the channel-suffix-stripped base names of the -A
                    # files (a basename check: '-A' in a directory name must
                    # not filter everything). For two_input_two_output the
                    # base .mel.npy need not exist; for one_output it is the
                    # mixed mel, the training target.
                    self.files = sorted(
                        f[: -len("-A.mel.npy")] + ".mel.npy"
                        for f in self.files if os.path.basename(f).endswith("-A.mel.npy"))
                    if self.format == "hubert_overlap_two_input_one_output":
                        self.files = [f for f in self.files if os.path.exists(f)]
        if self.dummy:
            self.files = self.files[: max(1, len(self.files) // 150)]
        # short-utterance pool for the 2-speaker synthetic augmentation: only
        # single-speaker items (a _1/_2 pair file has no 'xxx_1.txt')
        self.short_files = [f for f in self.files
                            if not os.path.basename(f).endswith("_1.hubert_code.npy")] or self.files

    def __len__(self):
        return len(self.files)

    # ---- acoustic items ----------------------------------------------------

    def _crop(self, mel: np.ndarray, codes: np.ndarray, start: Optional[int] = None,
              max_len: Optional[int] = None):
        max_len = self.max_len if max_len is None else max_len
        n = min(len(codes), mel.shape[1])
        mel, codes = mel[:, :n], codes[:n]
        if n > max_len:
            if start is None:
                start = self.rng.randint(0, n - max_len) if self.shuffle_spec else (n - max_len) // 2
            mel = mel[:, start : start + max_len]
            codes = codes[start : start + max_len]
        return mel, codes, start or 0

    def _mask(self, n: int, lo=0.5, hi=1.0):
        """Random contiguous mask covering a uniform fraction in [lo, hi) of
        the sequence; at the end unless `random_mask`."""
        frac = self.rng.uniform(lo, hi)
        length = int(frac * n)
        if self.random_mask and n > length:
            start = self.rng.randint(0, n - length)
        else:
            start = n - length  # fix mask at the end (prompt at the beginning)
        mask = np.zeros(n, bool)
        mask[start : start + length] = True
        return mask

    @staticmethod
    def _channel_codes(mel_path: str) -> np.ndarray:
        k16 = mel_path.replace(".mel.npy", "-16k.hubert_code.npy")
        return load_codes(k16 if os.path.exists(k16) else mel_path.replace(".mel.npy", ".hubert_code.npy"))

    def __getitem__(self, i: int) -> Dict:
        f = self.files[i]
        if self.format == "hubert_fisher":
            mel = np.load(f)
            codes = load_codes(f.replace(".mel.npy", ".hubert_code.npy"))
            mel, codes, _ = self._crop(mel, codes)
            mask = self._mask(len(codes))
            return {"x": mel.T.astype(np.float32), "phonemes": codes.astype(np.int32), "mask": mask}

        if self.format == "default":
            mel = np.load(f)
            codes = np.load(f.replace(".mel.npy", ".phone_by_frame.npy")).astype(int)
            mel, codes, _ = self._crop(mel, codes, max_len=1600)
            mask = self._mask(len(codes))
            return {"x": mel.T.astype(np.float32), "phonemes": codes.astype(np.int32), "mask": mask}

        if self.format in ("hubert_overlap_two_input_two_output", "hubert_overlap_two_input_one_output"):
            fa = f.replace(".mel.npy", "-A.mel.npy")
            fb = f.replace(".mel.npy", "-B.mel.npy")
            mel_a, codes_a, start = self._crop(np.load(fa), self._channel_codes(fa))
            mel_b, codes_b, _ = self._crop(np.load(fb), self._channel_codes(fb), start)
            mask = self._mask(min(len(codes_a), len(codes_b)), 0.3, 0.7)
            n = len(mask)
            phon = np.stack([codes_a[:n], codes_b[:n]], -1).astype(np.int32)
            if self.format == "hubert_overlap_two_input_two_output":
                x = np.concatenate([mel_a[:, :n].T, mel_b[:, :n].T], -1).astype(np.float32)
            else:
                mel_mix = np.load(f)
                mel_mix, _, _ = self._crop(mel_mix, np.zeros(mel_mix.shape[1], int), start)
                n = min(n, mel_mix.shape[1])
                x = np.concatenate([mel_a[:, :n].T, mel_b[:, :n].T, mel_mix[:, :n].T], -1).astype(np.float32)
                phon, mask = phon[:n], mask[:n]
            return {"x": x, "phonemes": phon, "mask": mask}

        if self.format == "text2semantic":
            codes = load_codes(f)[: self.t2s_max_len]
            txt_path = f.replace("-16k.hubert_code.npy", ".txt").replace(".hubert_code.npy", ".txt")
            with open(txt_path) as fh:
                text = fh.read()
            return {"text": text, "semantic": codes.astype(np.int32)}

        if self.format == "text2semantic_2output":
            return self._t2s_2output_item(f)

        raise ValueError(f"unknown format {self.format}")

    def _t2s_2output_item(self, f: str) -> Dict:
        """CoMix data augmentation: 40% single-speaker (stream B silence), 40%
        shifted to stream B with a leading [spkchange], 20% synthetic
        2-speaker concatenation."""
        def read_txt(path):
            with open(path.replace("-16k.hubert_code.npy", ".txt").replace(".hubert_code.npy", ".txt")) as fh:
                return fh.read()

        two_spk = "_1.hubert_code.npy" in os.path.basename(f)
        if two_spk:
            c1 = load_codes(f)
            c2 = load_codes(f.replace("_1.hubert_code.npy", "_2.hubert_code.npy"))
            n = max(len(c1), len(c2))
            c1 = np.pad(c1, (0, n - len(c1)), constant_values=SILENCE_TOKEN)
            c2 = np.pad(c2, (0, n - len(c2)), constant_values=SILENCE_TOKEN)
            text = read_txt(f.replace("_1.hubert_code.npy", ".hubert_code.npy"))
        else:
            p = self.rng.random()
            codes = load_codes(f)
            text = read_txt(f)
            if p < 0.40:
                c1, c2 = codes, np.full_like(codes, SILENCE_TOKEN)
            elif p < 0.80:
                c2, c1 = codes, np.full_like(codes, SILENCE_TOKEN)
                text = " [spkchange] " + text
            else:
                other = self.rng.choice(self.short_files)
                codes2 = load_codes(other)
                text = text + " [spkchange] " + read_txt(other)
                c1 = np.concatenate([codes, np.full_like(codes2, SILENCE_TOKEN)])
                c2 = np.concatenate([np.full_like(codes, SILENCE_TOKEN), codes2])
        sem = np.stack([c1, c2], -1)[: self.t2s_max_len].astype(np.int32)
        return {"text": text, "semantic": sem}


# ---------------------------------------------------------------------------
# collate


def collate_acoustic(items: List[Dict], bucket: int = 64) -> Dict[str, np.ndarray]:
    """Pad to a bucketed max length: mel -15, codes 501, mask False."""
    n = round_up(max(len(it["mask"]) for it in items), bucket)
    b = len(items)
    d = items[0]["x"].shape[-1]
    ph_shape = (b, n) if items[0]["phonemes"].ndim == 1 else (b, n, items[0]["phonemes"].shape[-1])
    out = {
        "x": np.full((b, n, d), MEL_PAD, np.float32),
        "phonemes": np.full(ph_shape, CODE_PAD, np.int32),
        "mask": np.zeros((b, n), bool),
    }
    for i, it in enumerate(items):
        t = len(it["mask"])
        out["x"][i, :t] = it["x"][:t]
        out["phonemes"][i, :t] = it["phonemes"][:t]
        out["mask"][i, :t] = it["mask"][:t]
    return out


def _collate_text_ids(items: List[Dict], tokenizer, max_text_len: int) -> np.ndarray:
    """Tokenized texts, right-padded with 0 to a multiple of 16."""
    text_ids, _ = tokenizer.batch_encode([it["text"] for it in items], max_length=max_text_len)
    ts = round_up(text_ids.shape[1], 16)
    return np.pad(text_ids, ((0, 0), (0, ts - text_ids.shape[1]))).astype(np.int32)


def collate_t2s(items: List[Dict], tokenizer, bucket: int = 64, max_text_len: int = 512) -> Dict[str, np.ndarray]:
    """{'text_ids': [B, S] int32 (pad 0, S a multiple of 16), 'semantic_ids':
    [B, T] or [B, T, 2] int32 (pad 501, T a multiple of `bucket`)}."""
    text_ids = _collate_text_ids(items, tokenizer, max_text_len)
    n = round_up(max(len(it["semantic"]) for it in items), bucket)
    b = len(items)
    sem_shape = (b, n) if items[0]["semantic"].ndim == 1 else (b, n, 2)
    sem = np.full(sem_shape, CODE_PAD, np.int32)
    for i, it in enumerate(items):
        sem[i, : len(it["semantic"])] = it["semantic"]
    return {"text_ids": text_ids, "semantic_ids": sem}


def compress_token_runs(tokens: np.ndarray):
    """Run-length compress a semantic token sequence [T] or [T, S] into
    (unique_tokens, durations), each [Tc, S] int64, each stream padded with
    CODE_PAD / 0 up to the longest stream's run count."""
    t = np.asarray(tokens)
    if t.ndim == 1:
        t = t[:, None]
    uniq_streams, dur_streams = [], []
    for s in range(t.shape[1]):
        seq = t[:, s]
        if len(seq) == 0:
            uniq_streams.append(np.zeros((0,), np.int64))
            dur_streams.append(np.zeros((0,), np.int64))
            continue
        starts = np.flatnonzero(np.concatenate([[True], seq[1:] != seq[:-1]]))
        uniq_streams.append(seq[starts].astype(np.int64))
        dur_streams.append(np.diff(np.concatenate([starts, [len(seq)]])).astype(np.int64))
    n = max((len(u) for u in uniq_streams), default=0)
    uniq = np.full((n, t.shape[1]), CODE_PAD, np.int64)
    dur = np.zeros((n, t.shape[1]), np.int64)
    for s in range(t.shape[1]):
        uniq[: len(uniq_streams[s]), s] = uniq_streams[s]
        dur[: len(dur_streams[s]), s] = dur_streams[s]
    return uniq, dur


def collate_t2s_duration(items: List[Dict], tokenizer, bucket: int = 64,
                         max_text_len: int = 512) -> Dict[str, np.ndarray]:
    """collate_t2s for duration-predicting T2S training: the semantic
    targets run-length compressed to (unique tokens, durations) per stream,
    padded CODE_PAD / 0 to a multiple of `bucket`; one stream gives [B, T],
    two [B, T, 2]."""
    text_ids = _collate_text_ids(items, tokenizer, max_text_len)
    comp = [compress_token_runs(it["semantic"]) for it in items]
    n = round_up(max((u.shape[0] for u, _ in comp), default=1), bucket)
    streams = comp[0][0].shape[1] if comp else 1
    uniq = np.full((len(items), n, streams), CODE_PAD, np.int64)
    dur = np.zeros((len(items), n, streams), np.int64)
    for i, (u, d) in enumerate(comp):
        uniq[i, : u.shape[0]] = u
        dur[i, : d.shape[0]] = d
    if streams == 1:
        uniq, dur = uniq[..., 0], dur[..., 0]
    return {"text_ids": text_ids, "semantic_ids": uniq.astype(np.int32), "durations": dur.astype(np.int32)}


_STACK_PAD = {"x": MEL_PAD, "phonemes": CODE_PAD, "mask": False,
              "text_ids": 0, "semantic_ids": CODE_PAD, "durations": 0}


def stack_microbatches(batches: List[Dict]) -> Dict[str, np.ndarray]:
    """Stack A collated batches into [A, b, ...] for gradient accumulation.
    Each collate buckets its own max length, so leaves are padded up to the
    common max with the collate's own pad value, which the losses ignore."""
    out = {}
    for k in batches[0].keys():
        leaves = [np.asarray(b[k]) for b in batches]
        tgt = tuple(max(a.shape[d] for a in leaves) for d in range(leaves[0].ndim))
        pad_val = _STACK_PAD.get(k, 0)
        padded = []
        for a in leaves:
            pw = [(0, t - s) for s, t in zip(a.shape, tgt)]
            padded.append(np.pad(a, pw, constant_values=pad_val) if any(p[1] for p in pw) else a)
        out[k] = np.stack(padded)
    return out


def data_loader(dataset, batch_size: int, collate, *, shuffle=True, seed=0, drop_last=True,
                num_workers: int = 0, transfer=None):
    """Endless epoch iterator (decode + pad in numpy). With num_workers > 0
    a producer thread fills a bounded queue (data.prefetch.PrefetchIterator)
    so disk IO and collate overlap the device step; `transfer` then runs on
    each batch in that thread (e.g. `prefetch.device_transfer`)."""

    def epochs():
        idx = np.arange(len(dataset))
        rng = np.random.RandomState(seed)
        while True:
            if shuffle:
                rng.shuffle(idx)
            for s in range(0, len(idx) - (batch_size - 1 if drop_last else 0), batch_size):
                batch_idx = idx[s : s + batch_size]
                if len(batch_idx) == 0:
                    continue
                yield collate([dataset[int(i)] for i in batch_idx])

    if num_workers > 0:
        from covomix_tpu_torch.data.prefetch import PrefetchIterator

        return PrefetchIterator(epochs(), buffer_size=max(2, num_workers), transfer=transfer)
    return epochs()

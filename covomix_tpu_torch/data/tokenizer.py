"""BERT-compatible WordPiece tokenizer, dependency- and network-free.

The reference tokenizes dialogue text with HuggingFace's
BertTokenizer.from_pretrained('bert-base-uncased') plus six added special
tokens (monologue_generation.py:92-104):
  [laughter] [spkchange] [spka] [spkb] [partialoverlap] [backchannel]

This module reimplements the same algorithm (BasicTokenizer lowercase +
accent-strip + punctuation split, then greedy longest-match WordPiece with
'##' continuations, [CLS]/[SEP] wrapping) against a local vocab.txt, so no
network/HF hub access is needed. Added tokens are matched before wordpiece,
exactly like HF's added-vocabulary pass.

If no vocab is supplied, a deterministic fallback vocab (char-level + the
special/added tokens) is built so the pipeline stays runnable end-to-end;
ids then differ from bert-base-uncased, which only matters when loading
reference-trained T2S checkpoints (pass the real vocab.txt for that)."""

from __future__ import annotations

import os
import unicodedata
from typing import List, Optional

COVOMIX_ADDED_TOKENS = ["[laughter]", "[spkchange]", "[spka]", "[spkb]", "[partialoverlap]", "[backchannel]"]
BERT_BASE_UNCASED_VOCAB_SIZE = 30522


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F) or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F)
    )


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """HF BasicTokenizer: clean, CJK-space, lowercase+strip accents, punct-split."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif _is_whitespace(ch):
            out.append(" ")
        else:
            out.append(ch)
    text = "".join(out)

    tokens = []
    for tok in text.strip().split():
        if lowercase:
            tok = tok.lower()
            tok = unicodedata.normalize("NFD", tok)
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
        # split on punctuation
        cur = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    def __init__(
        self,
        vocab_path: Optional[str] = None,
        added_tokens: Optional[List[str]] = None,
        unk_token: str = "[UNK]",
        max_chars_per_word: int = 100,
    ):
        if vocab_path and os.path.isfile(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                words = [line.rstrip("\n") for line in f]
        else:
            import warnings

            warnings.warn(
                "No BERT vocab.txt supplied — using the char-level fallback vocab. "
                "Token ids are NOT compatible with bert-base-uncased; any T2S "
                "checkpoint trained with the real vocab will decode garbage. "
                "Pass vocab_path=<bert-base-uncased vocab.txt> for checkpoint use.",
                stacklevel=2,
            )
            words = self._fallback_vocab()
        self.vocab = {w: i for i, w in enumerate(words)}
        self.inv_vocab = words
        self.unk_token = unk_token
        self.max_chars = max_chars_per_word
        self.added = {}
        self._n_appended = 0
        for t in added_tokens or []:
            # added tokens are ALWAYS whole-matched before basic tokenization
            # (else '[laughter]' splits into '[', 'laughter', ']'); a vocab.txt
            # that already contains them (an expanded 30528-line file) maps
            # them to their in-vocab ids instead of appending new ones (HF
            # add_tokens semantics: only genuinely new tokens extend the vocab)
            if t in self.vocab:
                self.added[t] = self.vocab[t]
            else:
                self.added[t] = len(self.vocab) + self._n_appended
                self._n_appended += 1
        self.cls_id = self.vocab.get("[CLS]", 101 if len(words) > 101 else 0)
        self.sep_id = self.vocab.get("[SEP]", 102 if len(words) > 102 else 0)
        self.pad_id = self.vocab.get("[PAD]", 0)
        self.unk_id = self.vocab.get(unk_token, 100 if len(words) > 100 else 0)

    @staticmethod
    def _fallback_vocab() -> List[str]:
        """Deterministic minimal vocab: specials + printable chars + '##' chars."""
        words = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + [str(d) for d in range(10)] + list("'-")
        words += chars + ["##" + c for c in chars]
        return words

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + self._n_appended

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, add_special_tokens: bool = True, max_length: Optional[int] = None) -> List[int]:
        """Mirrors tokenizer([text]).input_ids from the reference CLIs
        (monologue_generation.py:181): [CLS] ... [SEP] with added-token pass."""
        ids: List[int] = []
        # split on added special tokens first (HF added-vocabulary behavior)
        segments = [text]
        for tok in self.added:
            new_segments = []
            for seg in segments:
                if isinstance(seg, int):
                    new_segments.append(seg)
                    continue
                parts = seg.split(tok)
                for i, p in enumerate(parts):
                    if i > 0:
                        new_segments.append(self.added[tok])
                    new_segments.append(p)
            segments = new_segments
        for seg in segments:
            if isinstance(seg, int):
                ids.append(seg)
            else:
                for word in basic_tokenize(seg):
                    ids.extend(self._wordpiece(word))
        if add_special_tokens:
            ids = [self.cls_id] + ids + [self.sep_id]
        if max_length is not None and len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id] if add_special_tokens else ids[:max_length]
        return ids

    def batch_encode(self, texts: List[str], max_length: Optional[int] = 512):
        """Returns (padded ids [B, L] int32 numpy, attention mask) like
        tokenizer(texts, padding=True, truncation=True)."""
        import numpy as np

        if not texts:
            return np.zeros((0, 0), np.int32), np.zeros((0, 0), bool)
        encoded = [self.encode(t, max_length=max_length) for t in texts]
        L = max(len(e) for e in encoded)
        ids = np.full((len(encoded), L), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), L), bool)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = True
        return ids, mask

    def decode(self, ids) -> str:
        inv_added = {v: k for k, v in self.added.items()}
        toks = []
        for i in ids:
            i = int(i)
            if i in inv_added:
                toks.append(inv_added[i])
            elif 0 <= i < len(self.inv_vocab):
                toks.append(self.inv_vocab[i])
        out = []
        for t in toks:
            if t.startswith("##") and out:
                out[-1] += t[2:]
            else:
                out.append(t)
        return " ".join(out)


def load_covomix_tokenizer(vocab_path: Optional[str] = None, *,
                           strict: bool = False) -> WordPieceTokenizer:
    """The tokenizer the CoVoMix CLIs build: bert-base-uncased (+6 added tokens)
    (monologue_generation.py:92-104). Searches the HF cache if no path given.

    strict=True refuses to fall back to the char-level vocab and raises
    instead: the fallback's ids are checkpoint-incompatible, so a trained T2S
    model would silently decode garbage. The generation/serving CLIs pass
    strict unless --allow_fallback_vocab is given (smoke/random-weight use)."""
    if vocab_path is None:
        for cand in (
            os.environ.get("COVOMIX_BERT_VOCAB", ""),
            os.path.expanduser("~/.cache/huggingface/hub/models--bert-base-uncased/snapshots"),
        ):
            if cand and os.path.isdir(cand):
                for root, _, files in os.walk(cand):
                    if "vocab.txt" in files:
                        vocab_path = os.path.join(root, "vocab.txt")
                        break
            if cand and os.path.isfile(cand):
                vocab_path = cand
            if vocab_path:
                break
    if strict and not (vocab_path and os.path.isfile(vocab_path)):
        raise FileNotFoundError(
            "No bert-base-uncased vocab.txt found (searched --bert_vocab, "
            "$COVOMIX_BERT_VOCAB, the HF cache). Refusing the char-level "
            "fallback vocab: its token ids are incompatible with any T2S "
            "checkpoint trained on the real vocab and would decode garbage. "
            "Pass --bert_vocab <vocab.txt>, or --allow_fallback_vocab for "
            "random-weight smoke runs.")
    return WordPieceTokenizer(vocab_path, added_tokens=COVOMIX_ADDED_TOKENS)


def remove_punctuation(text: str) -> str:
    """Reference text cleanup (monologue_generation.py:108-114): lowercase and
    strip a fixed punctuation set (keeps '[' ']' so special tokens survive)."""
    punctuation = """!()-{};:'"\\,<>./?@#$%^&*_~"""
    text = text.lower()
    for x in list(text):
        if x in punctuation:
            text = text.replace(x, "")
    return text

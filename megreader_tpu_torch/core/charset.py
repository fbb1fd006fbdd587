"""Charsets: CTC (blank at index 0) and attention (PAD, GO, EOS, then characters)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

DIGITS = "0123456789"
LOWERCASE = "abcdefghijklmnopqrstuvwxyz"
DEFAULT_ALPHABET = DIGITS + LOWERCASE  # 36 chars; indices 1..36, blank=0


class Charset:
    """CTC charset: index 0 is reserved for blank."""

    BLANK = 0

    def __init__(self, alphabet: str = DEFAULT_ALPHABET,
                 case_sensitive: bool = False, unknown_as: str = ""):
        self.case_sensitive = case_sensitive
        if not case_sensitive:
            alphabet = "".join(dict.fromkeys(alphabet.lower()))
        self.alphabet = alphabet
        self.unknown_as = unknown_as
        self._c2i = {c: i + 1 for i, c in enumerate(alphabet)}
        self._i2c = {i + 1: c for i, c in enumerate(alphabet)}

    @property
    def num_classes(self) -> int:
        """Including blank."""
        return len(self.alphabet) + 1

    def normalize(self, text: str) -> str:
        if not self.case_sensitive:
            text = text.lower()
        return "".join(c for c in text if c in self._c2i)

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, int]:
        """-> (int32[max_len] padded with 0, true length). Drops unknown chars."""
        ids = [self._c2i[c] for c in self.normalize(text)][:max_len]
        out = np.zeros((max_len,), dtype=np.int32)
        out[: len(ids)] = ids
        return out, len(ids)

    def encode_batch(self, texts: Sequence[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        labels = np.zeros((len(texts), max_len), dtype=np.int32)
        lengths = np.zeros((len(texts),), dtype=np.int32)
        for i, t in enumerate(texts):
            labels[i], lengths[i] = self.encode(t, max_len)
        return labels, lengths

    def decode(self, ids: Sequence[int]) -> str:
        """Plain index->char lookup (no CTC collapse; see ops.ctc)."""
        return "".join(
            self._i2c.get(int(i), self.unknown_as) for i in ids if int(i) != self.BLANK
        )

    def decode_batch(self, ids: np.ndarray, lengths: np.ndarray) -> List[str]:
        return [self.decode(row[: int(n)]) for row, n in zip(np.asarray(ids), np.asarray(lengths))]


class AttentionCharset(Charset):
    """Charset for attentional decoders: PAD 0, GO 1, EOS 2, characters from 3
    (39 classes with the default alphabet)."""

    PAD, GO, EOS = 0, 1, 2
    NUM_SPECIAL = 3

    def __init__(self, alphabet: str = DEFAULT_ALPHABET, case_sensitive: bool = False):
        super().__init__(alphabet, case_sensitive)
        self._c2i = {c: i + self.NUM_SPECIAL for i, c in enumerate(self.alphabet)}
        self._i2c = {i + self.NUM_SPECIAL: c for i, c in enumerate(self.alphabet)}

    @property
    def num_classes(self) -> int:
        return len(self.alphabet) + self.NUM_SPECIAL

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, int]:
        """-> ids ended by EOS, then PAD; the length includes the EOS."""
        ids = [self._c2i[c] for c in self.normalize(text)][: max_len - 1]
        ids.append(self.EOS)
        out = np.full((max_len,), self.PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out, len(ids)

    def decode(self, ids: Sequence[int]) -> str:
        """Characters up to the first EOS; control tokens are dropped."""
        chars = []
        for i in ids:
            i = int(i)
            if i == self.EOS:
                break
            if i >= self.NUM_SPECIAL:
                chars.append(self._i2c.get(i, ""))
        return "".join(chars)

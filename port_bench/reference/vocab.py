"""A frozen copy of the port's `text/vocab.py`: the reference tokenizes the
served commands itself.  Its text follows.

Fixed vocabularies and tokenization helpers (the port's copy of
`dwcgan_tpu/text/vocab.py`, ids identical).

The reference ships hard-coded word lists (CelebA: 98 words, CUB200: 56 words)
plus PAD/BOS/EOS/UNK specials and pad-to-fixed-length packing
(the reference's `vocab.py:7-241`).  The word lists themselves are *data* —
they must match for command parity — but the surrounding machinery here is
NumPy/array-first: tokenization always yields fixed-shape int32 arrays so
everything device-side is static-shaped.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

PAD, BOS, EOS, UNK = "<_>", "<bos>", "<eos>", "<unk>"

# CelebA command vocabulary (reference: vocab.py:7-106).
_CELEBA_WORDS = (
    "black blond brown male female gender smile smiling happy unsmile "
    "unsmiling young younger old older age big glasses eyeglasses sunglasses "
    "beard beards make change translate modify reverse inverse increase add "
    "decrease reduce boy man gentleman sir woman lady miss girl moustache "
    "whiskers delighted laugh unhappy serious smileless solemn less more "
    "attractive attractiveness do not nothing anything everything keep "
    "unchanged his him it the its her face wear put on with remove take off "
    "without no to into and unknown"
).split() + [",", "."] + (
    "color colour hair from be a an this wearing gray left right but blonde"
).split() + [" ", "?", "!"]

# CUB-200 command vocabulary (reference: vocab.py:109-166).
_CUB200_WORDS = (
    "leg legs back crown wing wings breast eye eyes blue brown buff yellow "
    "white black red orange green grey change modify translate color colors "
    "into to and a an make"
).split() + [","] + (
    "add do not keep unchanged on nothing everything anything with"
).split() + ["."] + (
    "has bird undefined unknown type body it its the is of this be other"
).split()

_WORDLISTS = {"CelebA": _CELEBA_WORDS, "CUB200": _CUB200_WORDS}


class Vocab:
    """Token <-> id maps with fixed specials.

    Layout matches the reference (`vocab.py:168-185`): with sentence markers
    the id space is [PAD, BOS, EOS, UNK, *words]; without, [PAD, UNK, *words].
    CelebA size = 102 (98 words + 4 specials).
    """

    def __init__(self, dataset: str = "CelebA", with_markers: bool = True):
        # reference picks CelebA words for 'CelebA', CUB words otherwise (vocab.py:170-173)
        words = _WORDLISTS["CelebA"] if dataset == "CelebA" else _WORDLISTS["CUB200"]
        specials = [PAD, BOS, EOS, UNK] if with_markers else [PAD, UNK]
        self.itos: List[str] = specials + list(words)
        self.stoi = {tok: i for i, tok in enumerate(self.itos)}
        self.pad_id = self.stoi[PAD]
        self.unk_id = self.stoi[UNK]
        self.bos_id = self.stoi.get(BOS, -1)
        self.eos_id = self.stoi.get(EOS, -1)

    @property
    def size(self) -> int:
        return len(self.itos)

    def encode(self, token):
        if isinstance(token, (list, tuple)):
            return [self.encode(t) for t in token]
        return self.stoi.get(token, self.unk_id)

    def decode(self, idx):
        if isinstance(idx, (list, tuple, np.ndarray)):
            return [self.decode(int(i)) for i in idx]
        return self.itos[int(idx)]


def tokens_to_ids(
    batch: Sequence[Sequence[str]],
    vocab: Vocab,
    max_len: int = 80,
    add_bos: bool = True,
    add_eos: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize a batch of word lists to a fixed-shape `[B, max_len + 2]` array.

    Mirrors the reference's `ListsToTensor` (`vocab.py:220-235`): truncate to
    `max_len` words, prepend BOS / append EOS, pad with PAD to a constant
    width so device shapes never vary.  Returns `(ids, lengths)`; `lengths`
    counts BOS + words + EOS and is clamped to >= 1.
    """
    extra = int(add_bos) + int(add_eos)
    width = max_len + extra
    ids = np.full((len(batch), width), vocab.pad_id, dtype=np.int32)
    lens = np.zeros((len(batch),), dtype=np.int32)
    for i, words in enumerate(batch):
        words = list(words)[:max_len]
        seq = ([vocab.bos_id] if add_bos else []) + [vocab.encode(w) for w in words] \
            + ([vocab.eos_id] if add_eos else [])
        ids[i, : len(seq)] = seq
        lens[i] = max(1, len(seq))
    return ids, lens


def pad_tokens(words: Iterable[str], max_len: int = 80) -> Tuple[List[str], int]:
    """String-level padding variant (reference: `vocab.py:237-241`)."""
    ws = list(words)[:max_len]
    length = len(ws) + 2
    return [BOS] + ws + [EOS] + [PAD] * (max_len - length + 2), length


def encode_commands(commands: Sequence[str], vocab: Vocab, max_len: int = 80):
    """Whitespace-tokenize raw command strings to fixed-shape ids + lengths."""
    return tokens_to_ids([c.split() for c in commands], vocab, max_len=max_len)

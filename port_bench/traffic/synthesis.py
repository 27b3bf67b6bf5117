"""A frozen copy of the port's `text/synthesis.py`, the template engine the
serve traffic draws its commands from.  Its text follows.

On-the-fly training-command synthesis (the port's copy of
`dwcgan_tpu/text/synthesis.py`; the same draws give the same commands).

DWC-GAN has no human-annotated text: every training command is generated from a
(source-label, target-label) pair by a template engine with synonym banks
(reference: `data_ios/celeba_text.py`).  Three modes exist:

- ``diff``    — describe only the *changes*           (celeba_text.py:218-251)
- ``overall`` — describe the *target* face            (celeba_text.py:253-283)
- ``mixed``   — source description -> target          (celeba_text.py:285-318)

This runs on the host (pure string work) and stays off the device; the
device only ever sees fixed-shape token arrays.  Unlike the reference (module
-level `random`), randomness is an explicit `random.Random` so pipelines are
reproducible and decorrelated per worker.

Attribute layout (reference: celeba_text.py:6-15):
    0 Black_Hair, 1 Blond_Hair, 2 Brown_Hair, 3 Male, 4 Smiling, 5 Young,
    6 Eyeglasses, 7 No_Beard (1 = *no* beard)
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np

CELEBA_ATTRS = (
    "Black_Hair", "Blond_Hair", "Brown_Hair", "Male",
    "Smiling", "Young", "Eyeglasses", "No_Beard",
)
GENDER_IDX = 3
HAIR_SLICE = slice(0, 3)

# ---- synonym banks (data constants; reference: celeba_text.py:19-39) ----
HAIR_COLORS = ["black", "blond", "brown"]
CHANGE = ["make", "change", "translate", "modify"]
REVERSE = ["change", "reverse", "inverse"]
INCREASE = ["increase", "add"]
DECREASE = ["decrease", "reduce"]
MALE_WORDS = ["boy", "male", "man", "gentleman", "sir"]
FEMALE_WORDS = ["female", "woman", "lady", "miss", "girl"]
BEARD_WORDS = ["beard", "moustache", "whiskers", "beards"]
GLASSES_WORDS = ["glasses", "eyeglasses", "sunglasses"]
SMILE_WORDS = ["smile", "smiling", "happy", "delighted", "laugh"]
UNSMILE_WORDS = ["unsmiling", "unhappy", "serious", "smileless", "solemn",
                 "less smile", "more serious"]
YOUNG_WORDS = ["young", "younger"]
OLD_WORDS = ["old", "older", "big age"]
ADD_STATUS = ["wear", "add", "put on", "with"]       # glasses_add == beard_add
REMOVE_STATUS = ["remove", "take off", "without", "no"]
SUFFIXES = [" .", "", "?", " ", "!"]                 # celeba_text.py:325
TO_INTO = ["to", "into"]


class TextSynthesizer:
    """Generates natural-language edit commands from label pairs."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.rng = rng if rng is not None else random.Random()

    # ---------------- small helpers ----------------

    def _pick(self, seq: Sequence[str]) -> str:
        return self.rng.choice(list(seq))

    def _poss(self, is_male) -> str:
        # "his"/"her"/"the" (celeba_text.py:42-43)
        return self._pick(["his" if is_male else "her", "the"])

    def _obj(self, is_male) -> str:
        # "him"/"her"/"it" (celeba_text.py:137 etc.)
        return self._pick(["him" if is_male else "her", "it"])

    def _gender_word(self, is_male) -> str:
        return self._pick(MALE_WORDS if is_male else FEMALE_WORDS)

    def _smile_word(self, smiling) -> str:
        return self._pick(SMILE_WORDS if smiling else UNSMILE_WORDS)

    def _age_word(self, young) -> str:
        return self._pick(YOUNG_WORDS if young else OLD_WORDS)

    def _nothing(self, topic: str = "", is_male=0) -> str:
        # (celeba_text.py:45-61)
        if topic == "":
            return self._pick(["", "do nothing", "no changes",
                               "do not change anything"])
        poss = self._poss(is_male)
        return self._pick([
            "",
            f"do nothing on {poss} {topic}",
            f"do not change {poss} {topic}",
            f"keep {topic} unchanged",
            f"keep {poss} {topic} unchanged",
        ])

    def _color_phrase(self, active_idx: Sequence[int], shuffle: bool = True) -> str:
        # (celeba_text.py:63-75)
        if len(active_idx) == 0:
            return "unknown"
        colors = [HAIR_COLORS[i] for i in active_idx]
        if shuffle:
            self.rng.shuffle(colors)
        if len(colors) < 3:
            return " and ".join(colors)
        return " , ".join(colors[:-1]) + f" and {colors[-1]}"

    def _join_listing(self, parts: List[str]) -> str:
        # "a , b and c" vs "a and b and c" coin flip (celeba_text.py:279-282)
        if self.rng.random() > 0.5:
            return " , ".join(parts[:-1]) + f" and {parts[-1]}"
        return " and ".join(parts)

    # ---------------- per-attribute editors ----------------

    def edit_hair(self, src: np.ndarray, trg: np.ndarray) -> str:
        # (celeba_text.py:77-99)
        s, t = src[HAIR_SLICE], trg[HAIR_SLICE]
        if np.abs(s - t).sum() == 0:
            return self._nothing("hair color", trg[GENDER_IDX])
        trg_txt = self._color_phrase(np.nonzero(t)[0])
        src_txt = self._color_phrase(np.nonzero(s)[0])
        poss = self._poss(trg[GENDER_IDX])
        color = self._pick(["color", "colour"])
        return self._pick([
            f"{self._pick(CHANGE)} hair {color} {trg_txt}",
            f"{self._pick(CHANGE)} {poss} {src_txt} hair {self._pick(TO_INTO)} {trg_txt}",
            f"{self._pick(CHANGE)} {poss} hair {color} from {src_txt} {self._pick(TO_INTO)} {trg_txt}",
            f"{trg_txt} hair",
            f"{trg_txt} hair {color}",
        ])

    def edit_gender(self, src, trg) -> str:
        # (celeba_text.py:101-133)
        if src - trg == 0:
            return self._pick([
                self._nothing("gender", src),
                f"{self._pick(CHANGE)} {self._poss(src)} gender "
                f"{self._pick(TO_INTO)} {self._gender_word(trg)}",
                f"{self._pick(CHANGE)} the gender from {self._gender_word(src)} "
                f"{self._pick(TO_INTO)} {self._gender_word(trg)}",
            ])
        face_src = self._pick((MALE_WORDS if src else FEMALE_WORDS) + ["face"])
        face_trg = self._pick((MALE_WORDS if trg else FEMALE_WORDS) + ["face"])
        return self._pick([
            f"{self._pick(CHANGE)} {self._poss(src)} gender",
            f"{self._pick(CHANGE)} {self._poss(src)} gender "
            f"{self._pick(TO_INTO)} {self._gender_word(trg)}",
            f"{self._pick(CHANGE)} the gender from {self._gender_word(src)} "
            f"{self._pick(TO_INTO)} {self._gender_word(trg)}",
            f"{self._pick(REVERSE)} the gender",
            f"{self._pick(REVERSE)} gender",
            f"{self._pick(CHANGE)} the {face_src} to be a {face_trg}",
            self._gender_word(trg),
        ])

    def edit_smile(self, src, trg, is_male=0) -> str:
        # (celeba_text.py:135-159).  NB the reference draws the add/remove verb
        # from the *beard* banks here; preserved for distribution parity.
        if src - trg == 0:
            return self._pick([
                f"keep {self._poss(is_male)} face {self._smile_word(trg)}",
                f"keep {self._obj(is_male)} {self._smile_word(trg)}",
                self._nothing(self._smile_word(trg), is_male),
            ])
        status = self._pick(ADD_STATUS if trg else REMOVE_STATUS)
        return self._pick([
            self._smile_word(trg),
            f"{self._pick(CHANGE)} {self._poss(is_male)} face {self._smile_word(trg)}",
            f"{self._pick(CHANGE)} {self._poss(is_male)} face to be {self._smile_word(trg)}",
            f"{status} {self._pick(['smile', 'the smile'])}",
            "smile" if trg else "do not smile",
        ])

    def edit_age(self, src, trg, is_male=0) -> str:
        # (celeba_text.py:161-182)
        if src - trg == 0:
            return self._nothing("age", is_male)
        trg_age = self._age_word(trg)
        updown = self._pick(INCREASE if trg else DECREASE)
        return self._pick([
            trg_age,
            f"{self._pick(CHANGE)} {self._poss(is_male)} face {trg_age}",
            f"{self._pick(CHANGE)} {self._obj(is_male)} {trg_age}",
            f"{self._pick(CHANGE)} {self._poss(is_male)} face {self._pick(TO_INTO)} be {trg_age}",
            f"{self._pick(CHANGE)} {self._obj(is_male)} to be {trg_age}",
            f"{updown} age",
            f"{self._pick(REVERSE)} {self._poss(is_male)} age",
            f"{updown} {self._poss(is_male)} age",
        ])

    def edit_glasses(self, src, trg, is_male=0) -> str:
        # (celeba_text.py:184-198)
        if src - trg == 0:
            return self._nothing("eyeglasses", is_male)
        status = self._pick(ADD_STATUS if trg else REMOVE_STATUS)
        word = self._pick(GLASSES_WORDS)
        return self._pick([
            f"{status} {word}",
            f"{self._pick(CHANGE)} {self._poss(is_male)} face {status} {word}",
            f"{self._pick(CHANGE)} {self._obj(is_male)} {status} {word}",
        ])

    def edit_beard(self, src, trg, is_male=0) -> str:
        # (celeba_text.py:200-215).  Attribute is No_Beard: trg=1 => remove.
        if src - trg == 0:
            return self._nothing("beard", is_male)
        status = self._pick(REMOVE_STATUS if trg else ADD_STATUS)
        word = self._pick(BEARD_WORDS)
        return self._pick([
            f"{status} {word}",
            f"{status} {self._pick(['a', 'the'])} {word}",
            f"{self._pick(CHANGE)} {self._poss(is_male)} face {status} {word}",
            f"{self._pick(CHANGE)} {self._obj(is_male)} {status} {word}",
        ])

    # ---------------- modes ----------------

    def diff2text(self, src_lab: np.ndarray, trg_lab: np.ndarray) -> str:
        """Describe only the changed attributes, in random order."""
        src_lab = np.asarray(src_lab)
        trg_lab = np.asarray(trg_lab)
        if np.abs(src_lab - trg_lab).sum() == 0:
            # (celeba_text.py:222-228)
            poss = self._poss(src_lab[GENDER_IDX])
            obj = self._pick(["him" if src_lab[GENDER_IDX] else "her", "it",
                              "everything"])
            return self._pick([
                f"do nothing on {poss} face",
                f"do not {self._pick(CHANGE)} anything",
                f"keep {obj} unchanged",
            ])
        is_male = trg_lab[GENDER_IDX]
        editors = [
            (GENDER_IDX, lambda: self.edit_gender(src_lab[3], trg_lab[3])),
            (4, lambda: self.edit_smile(src_lab[4], trg_lab[4], is_male)),
            (5, lambda: self.edit_age(src_lab[5], trg_lab[5], is_male)),
            (6, lambda: self.edit_glasses(src_lab[6], trg_lab[6], is_male)),
            (7, lambda: self.edit_beard(src_lab[7], trg_lab[7], is_male)),
        ]
        parts = [fn() for _, fn in editors]
        parts.append(self.edit_hair(src_lab, trg_lab))
        parts = [p for p in parts if p != ""]
        self.rng.shuffle(parts)
        return " . ".join(parts).strip()

    def overall2text(self, trg_lab: np.ndarray, is_start: bool = True) -> str:
        """Describe the whole target face (celeba_text.py:253-283)."""
        trg_lab = np.asarray(trg_lab)
        txt = self._pick(["", "this is ", "it is "]) if is_start else ""
        txt += self._pick(["a ", "an "])
        attr = [self._smile_word(trg_lab[4]), self._age_word(trg_lab[5])]
        self.rng.shuffle(attr)
        for a in attr:
            txt += a + " "
        txt += self._gender_word(trg_lab[GENDER_IDX]) + " "
        parts = [
            f"with {self._color_phrase(np.nonzero(trg_lab[HAIR_SLICE])[0])} hair",
            f"{self._pick(REMOVE_STATUS if trg_lab[7] else ADD_STATUS)} {self._pick(BEARD_WORDS)}",
            f"{self._pick(ADD_STATUS if trg_lab[6] else REMOVE_STATUS)} {self._pick(GLASSES_WORDS)}",
        ]
        self.rng.shuffle(parts)
        return (txt + self._join_listing(parts)).strip()

    def mixed2text(self, src_lab: np.ndarray, trg_lab: np.ndarray) -> str:
        """Source description -> target description (celeba_text.py:285-318)."""
        src_lab = np.asarray(src_lab)
        trg_lab = np.asarray(trg_lab)
        txt = f"{self._pick(CHANGE)} the "
        attr = [self._smile_word(trg_lab[4]), self._age_word(trg_lab[5])]
        self.rng.shuffle(attr)
        for a in attr:
            if self.rng.random() > 0.5:
                txt += a + " "
        txt += self._gender_word(src_lab[GENDER_IDX]) + " "
        parts = [
            f"with {self._color_phrase(np.nonzero(src_lab[HAIR_SLICE])[0])} hair",
            f"{'without' if src_lab[7] else self._pick(['with', 'wearing'])} {self._pick(BEARD_WORDS)}",
            f"{self._pick(['with', 'wearing']) if src_lab[6] else 'without'} {self._pick(GLASSES_WORDS)}",
        ]
        self.rng.shuffle(parts)
        kept = [p for p in parts if self.rng.random() > 0.5]
        if len(kept) == 3:
            txt += " , ".join(kept[:2]) + f" and {kept[-1]}"
        elif kept:
            txt += " and ".join(kept)
        txt += " to " + self.overall2text(trg_lab, is_start=False)
        return txt.strip()

    def labels2text(self, src_lab, trg_lab) -> str:
        """Random mode + random punctuation suffix (celeba_text.py:320-325)."""
        mode = self.rng.choice([self.diff2text, None, self.mixed2text])
        if mode is None:
            body = self.overall2text(trg_lab)
        else:
            body = mode(np.asarray(src_lab), np.asarray(trg_lab))
        return body + self._pick(SUFFIXES)

    __call__ = labels2text

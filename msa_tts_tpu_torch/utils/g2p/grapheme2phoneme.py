"""Grapheme→phoneme conversion.

Mirrors the conversion modes of the reference G2P wrapper
(reference: msa_tts/utils/g2p/grapheme2phoneme.py:80-89):

  * ``phone_to_idx``            — metafile is already phonemized; map IPA
                                  string to vocabulary indices (training path,
                                  no external binary needed).
  * ``text_to_phone_to_idx``    — live phonemization (inference path).
  * ``text_to_phone_to_idx_aligned`` — live phonemization with per-word
                                  alignment spans.

Live phonemization shells out to ``espeak-ng``/``espeak`` when the binary
is installed (the reference vendors a phonemizer fork around the same
subprocess, msa_tts/utils/g2p/phonemizer_api/backend/espeak.py:349).  When
no binary is present we fall back to a deterministic rule-based English
letter-to-IPA mapping so that synthesis demos and tests run hermetically.
"""

from __future__ import annotations

import logging
import re
import shutil
import subprocess

from .char_list import CHAR_TO_ID, PAD, PUNCTUATIONS, char_list
from .festival import FestivalBackend
from .punctuation import Punctuation

# Matches espeak "language switch" flags such as "(en)" that appear when the
# engine switches voice mid-utterance; the reference removes them
# (language_switch="remove-flags").
_LANG_FLAG_RE = re.compile(r"\([a-zA-Z][a-zA-Z-]*\)")
_STRESS_CHARS = "ˈˌːˑ"


def merge_espeak_lines(out: str) -> str:
    """Merge espeak's wrapped multi-line output into one line exactly as
    the reference postprocess does (strip, newline→space, collapse the
    double space a space-led continuation line produces —
    phonemizer_api/backend/espeak.py:281).  Shared by the training G2P
    path here and the public ``phonemize()`` API (phonemize.py)."""
    return out.strip().replace("\n", " ").replace("  ", " ")


def apply_language_switch(line: str, mode: str) -> str | None:
    """Reference ``language_switch`` policies (espeak.py:286-300).
    Returns None when ``remove-utterance`` drops the line."""
    if mode == "remove-utterance":
        return None if _LANG_FLAG_RE.search(line) else line
    if mode == "remove-flags":
        return _LANG_FLAG_RE.sub("", line)
    if mode == "keep-flags":
        return line
    raise RuntimeError(
        f"lang_switch argument {mode!r} invalid, must be in "
        "keep-flags, remove-flags, remove-utterance"
    )


def find_espeak() -> str | None:
    for name in ("espeak-ng", "espeak"):
        path = shutil.which(name)
        if path:
            return path
    return None


class EspeakBackend:
    """Thin subprocess wrapper around the espeak binary."""

    def __init__(self, binary: str | None = None):
        self.binary = binary or find_espeak()
        if self.binary is None:
            raise RuntimeError("no espeak/espeak-ng binary found on PATH")

    def phonemize_chunk(self, text: str, language: str = "en-us") -> str:
        out = subprocess.run(
            [self.binary, "-q", "--ipa", "-v", language, "--", text],
            capture_output=True,
            text=True,
            check=True,
        ).stdout
        out = merge_espeak_lines(out)
        # Remove language-switch flags and tie bars espeak may emit.
        out = apply_language_switch(out, "remove-flags")
        out = out.replace("͡", "").replace("‍", "")
        return out


# Deterministic fallback letter→IPA rules (approximate en-US mapping).  Not
# linguistically accurate — it exists so that the text→speech path stays
# runnable end to end in environments without espeak.
_FALLBACK_DIGRAPHS = [
    ("tch", "tʃ"), ("sh", "ʃ"), ("ch", "tʃ"), ("th", "θ"), ("ph", "f"),
    ("wh", "w"), ("ng", "ŋ"), ("qu", "kw"), ("ck", "k"), ("oo", "uː"),
    ("ee", "iː"), ("ea", "iː"), ("ou", "aʊ"), ("ow", "aʊ"), ("ai", "eɪ"),
    ("ay", "eɪ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("ar", "ɑː"), ("er", "ɚ"),
    ("or", "ɔː"),
]
_FALLBACK_SINGLE = {
    "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f", "g": "ɡ",
    "h": "h", "i": "ɪ", "j": "dʒ", "k": "k", "l": "l", "m": "m", "n": "n",
    "o": "ɒ", "p": "p", "q": "k", "r": "ɹ", "s": "s", "t": "t", "u": "ʌ",
    "v": "v", "w": "w", "x": "ks", "y": "j", "z": "z",
}


class FallbackBackend:
    """Rule-based English letter→IPA mapping used when espeak is absent."""

    def word_phone_lists(self, text: str,
                         language: str = "en-us") -> list[list[str]]:
        """Per-word phone-token lists (the native unit this backend
        produces — lets ``phonemize()`` apply phone separators)."""
        words = []
        for word in text.lower().split():
            out = []
            i = 0
            while i < len(word):
                for pat, rep in _FALLBACK_DIGRAPHS:
                    if word.startswith(pat, i):
                        out.append(rep)
                        i += len(pat)
                        break
                else:
                    ch = word[i]
                    if ch in _FALLBACK_SINGLE:
                        out.append(_FALLBACK_SINGLE[ch])
                    elif ch in PUNCTUATIONS or ch == " ":
                        out.append(ch)
                    i += 1
            if out:
                # Rudimentary primary stress on the word.
                words.append(["ˈ" + out[0]] + out[1:])
        return words

    def phonemize_chunk(self, text: str, language: str = "en-us") -> str:
        return " ".join(
            "".join(w) for w in self.word_phone_lists(text, language)
        )


class SegmentsBackend:
    """Grapheme-map backend: longest-match tokenization over a
    tab-separated ``grapheme\\tIPA`` profile file (the format of the
    reference's vendored segments ``.g2p`` profiles —
    msa_tts/utils/g2p/phonemizer_api/backend/segments.py).

    ``profile_path`` is either a file path or the bare name of a
    bundled language profile (``profiles/<name>.g2p`` next to this
    module — hand-authored mappings, not the reference's files); the
    reference resolves language names against its ``share/segments``
    directory the same way (segments.py:79 is_supported_language)."""

    def __init__(self, profile_path: str):
        import os

        if not os.path.isfile(profile_path):
            bundled = self.supported_languages().get(profile_path)
            if bundled is None:
                raise ValueError(
                    f"segments profile {profile_path!r} is neither a "
                    "file nor a bundled language "
                    f"({sorted(self.supported_languages())})"
                )
            profile_path = bundled
        self.mapping: dict[str, str] = {}
        with open(profile_path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                parts = line.split("\t")
                if len(parts) >= 2 and parts[0].lower() != "grapheme":
                    self.mapping[parts[0]] = parts[1]
        if not self.mapping:
            raise ValueError(f"empty g2p profile: {profile_path}")
        self._max_len = max(len(k) for k in self.mapping)

    @staticmethod
    def supported_languages() -> dict[str, str]:
        """name -> path of the bundled ``profiles/*.g2p`` maps
        (reference segments.py:62 supported_languages)."""
        import os

        d = os.path.join(os.path.dirname(__file__), "profiles")
        if not os.path.isdir(d):
            return {}
        return {
            f[:-4]: os.path.join(d, f)
            for f in sorted(os.listdir(d))
            if f.endswith(".g2p")
        }

    def word_phone_lists(self, text: str,
                         language: str = "") -> list[list[str]]:
        """Per-word phone-token lists from longest-match tokenization
        (lets ``phonemize()`` apply phone separators)."""
        out = []
        for word in text.lower().split():
            phones = []
            i = 0
            while i < len(word):
                for L in range(min(self._max_len, len(word) - i), 0, -1):
                    piece = word[i : i + L]
                    if piece in self.mapping:
                        phones.append(self.mapping[piece])
                        i += L
                        break
                else:
                    if word[i] in PUNCTUATIONS:
                        phones.append(word[i])
                    i += 1  # unknown grapheme: skip (lenient mode)
            if phones:
                out.append(phones)
        return out

    def phonemize_chunk(self, text: str, language: str = "") -> str:
        return " ".join(
            "".join(w) for w in self.word_phone_lists(text, language)
        )


class Grapheme2Phoneme:
    """Text/phoneme to index-sequence converter over the IPA vocabulary."""

    def __init__(self, backend: str = "auto",
                 segments_profile: str | None = None):
        self.char_list = char_list
        self.char_to_id = CHAR_TO_ID
        self.id_to_char = {i: c for c, i in CHAR_TO_ID.items()}
        # the reference preserves exactly the vocabulary's punctuation
        # marks (grapheme2phoneme.py:22 punctuation_marks=_punctuations)
        self._punct = Punctuation(PUNCTUATIONS)
        if backend == "espeak":
            self.backend = EspeakBackend()
            self.backend_name = "espeak"
        elif backend == "festival":
            self.backend = FestivalBackend()
            self.backend_name = "festival"
        elif backend == "fallback":
            self.backend = FallbackBackend()
            self.backend_name = "fallback"
        elif backend == "segments":
            if not segments_profile:
                raise ValueError(
                    "segments backend needs a grapheme-map profile path"
                )
            self.backend = SegmentsBackend(segments_profile)
            self.backend_name = "segments"
        else:  # auto
            if find_espeak():
                self.backend = EspeakBackend()
                self.backend_name = "espeak"
            else:
                self.backend = FallbackBackend()
                self.backend_name = "fallback"
                # Degraded mode must be LOUD: the rule-based mapper keeps
                # demos running but its phone strings do NOT match
                # espeak-phonemized training metafiles — a server quietly
                # running on it would synthesize from wrong phonemes.
                logging.getLogger(__name__).warning(
                    "g2p: no espeak binary found — live phonemization is "
                    "running on the approximate rule-based fallback. "
                    "Phone strings will differ from espeak-phonemized "
                    "training data; install espeak-ng for faithful "
                    "inference (backend='fallback' silences this)."
                )

    # ------------------------------------------------------------------ text
    def text_to_phone(self, text: str, language: str = "en-us",
                      with_stress: bool = True) -> str:
        """Phonemize free text, preserving punctuation marks with the
        reference pipeline's hide→phonemize→restore protocol
        (phonemizer_api/backend/base.py:91-133): each chunk is
        phonemized with a trailing word separator (strip=False), then
        the marks — including their original surrounding whitespace —
        are spliced back, so punctuation lands space-separated exactly
        as the reference emits it."""
        chunks, marks = self._punct.preserve([text])
        phonemized = [
            self.backend.phonemize_chunk(c, language) + " " for c in chunks
        ]
        restored = Punctuation.restore(phonemized, marks)
        phones = "\n".join(restored)
        if not with_stress:
            phones = "".join(c for c in phones if c not in _STRESS_CHARS)
        return phones

    # --------------------------------------------------------------- indices
    def _keep(self, ch: str) -> bool:
        return ch in self.char_to_id and ch != PAD

    def phone_to_index_list(self, phones: str, **kwargs):
        seq = [self.char_to_id[c] for c in phones if self._keep(c)]
        return seq, phones

    def text_to_phone_to_index_list(self, text: str, **kwargs):
        phones = self.text_to_phone(text, language=kwargs.get("language", "en-us"))
        seq = [self.char_to_id[c] for c in phones if self._keep(c)]
        if not seq:
            print(f"!! After phoneme conversion the result is empty. -- {text}")
        return seq, phones

    def text_to_phone_to_index_list_alignment(self, text: str, **kwargs):
        """Phonemize with per-word (start, end) spans into the phone
        string.  (The reference smuggles a ``" ::: "`` separator through
        the phonemizer; phonemizing word-by-word gives the same spans
        without relying on the engine preserving the marker.)"""
        language = kwargs.get("language", "en-us")
        words = text.split()
        per_word = [
            self.text_to_phone(w, language=language) for w in words
        ]

        word_to_idx = []
        start = 0
        for word, phone in zip(words, per_word):
            end = start + len(phone) - 1
            word_to_idx.append((word, (start, end)))
            start = end + 1
        final = "".join(per_word)
        seq = [self.char_to_id[c] for c in final if self._keep(c)]
        if not seq:
            print(f"!! After phoneme conversion the result is empty. -- {text}")
        return seq, word_to_idx

    def convert(self, inp: str, **kwargs):
        mode = kwargs["convert_mode"]
        if mode == "phone_to_idx":
            return self.phone_to_index_list(inp, **kwargs)
        if mode == "text_to_phone_to_idx":
            return self.text_to_phone_to_index_list(inp, **kwargs)
        if mode == "text_to_phone_to_idx_aligned":
            return self.text_to_phone_to_index_list_alignment(inp, **kwargs)
        raise ValueError(f"unknown convert_mode: {mode}")

    def get_char_list(self):
        return self.char_list

"""Public ``phonemize()`` API with configurable separators.

Reference parity for the last uncovered surface of the vendored
phonemizer (msa_tts/utils/g2p/phonemizer_api/phonemize.py:31,
separator.py): a ``Separator(word, syllable, phone)`` triple, ``strip``
semantics, ``njobs`` chunked parallel phonemization, punctuation
preserve/remove, espeak stress and language-switch policies.

The training/inference path (``Grapheme2Phoneme``) does not use custom
separators — this module exists for users of the reference's
standalone ``phonemize()`` entry point.  Backend notes:

  * espeak — runs the binary with ``--sep=_`` (the reference's
    protocol, espeak.py:239) and post-processes per the reference's
    ``_postprocess_line`` (:278-312), including the espeak-ng
    fix for the espeak-ng separator artifact (its bug 694).
  * festival — full word/syllable/phone structure from the
    SylStructure tree; the only backend honouring ``separator.syllable``
    (reference festival.py:225-248).
  * segments / fallback — phone-level assembly from their native
    per-phone token lists; syllable separator ignored (as in the
    reference's segments backend).

``espeak-mbrola`` is not supported (the reference's mbrola path needs
voice data never used by this project); requesting it raises
RuntimeError.
"""

from __future__ import annotations

import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

from .festival import FestivalBackend, parse_sexpr
from .grapheme2phoneme import apply_language_switch, merge_espeak_lines
from .punctuation import DEFAULT_MARKS, Punctuation


class Separator:
    """Phone / syllable / word boundary tokens (reference
    separator.py:18): all non-empty separators must be distinct."""

    def __init__(self, word: str | None = " ",
                 syllable: str | None = None,
                 phone: str | None = None):
        non_empty = [s for s in (phone, syllable, word) if s]
        if len(non_empty) != len(set(non_empty)):
            raise ValueError(
                f'illegal separator with word="{word}", '
                f'syllable="{syllable}" and phone="{phone}", '
                f"must be all differents if not empty"
            )
        self._phone = str(phone) if phone else ""
        self._syllable = str(syllable) if syllable else ""
        self._word = str(word) if word else ""

    def __eq__(self, other):
        if not isinstance(other, Separator):
            return NotImplemented
        return (
            self.phone == other.phone
            and self.syllable == other.syllable
            and self.word == other.word
        )

    def __str__(self):
        return (
            f'(phone: "{self.phone}", syllable: "{self.syllable}", '
            f'word: "{self.word}")'
        )

    @property
    def phone(self):
        return self._phone

    @property
    def syllable(self):
        return self._syllable

    @property
    def word(self):
        return self._word


default_separator = Separator(word=" ", syllable="", phone="")


# ---------------------------------------------------------------------------
# espeak line pipeline (reference espeak.py:278-312)
# ---------------------------------------------------------------------------

def _espeak_raw(binary: str, line: str, language: str) -> str:
    return subprocess.run(
        [binary, "-q", "--ipa", "--sep=_", "-v", language, "--", line],
        capture_output=True, text=True, check=True,
    ).stdout


def _espeak_postprocess_line(line: str, separator: Separator,
                             strip: bool, with_stress: bool,
                             language_switch: str) -> str:
    # merge espeak's wrapped output into one line (shared with the
    # training-path backend — grapheme2phoneme.merge_espeak_lines)
    line = merge_espeak_lines(line)
    # espeak-ng bug 694: spurious trailing separators on some words
    line = re.sub(r"_+", "_", line)
    line = re.sub(r"_ ", " ", line)

    line = apply_language_switch(line, language_switch)
    if line is None:
        return ""

    out_line = ""
    for word in line.split(" "):
        word = word.strip()
        if not with_stress:
            for ch in ("ˈ", "ˌ", "'", "-"):
                word = word.replace(ch, "")
        if not strip:
            word += "_"
        word = word.replace("_", separator.phone)
        out_line += word + separator.word
    if strip and separator.word:
        out_line = out_line[: -len(separator.word)]
    return out_line


# ---------------------------------------------------------------------------
# festival separator assembly (reference festival.py:225-248)
# ---------------------------------------------------------------------------

def _festival_line(tree_line: str, separator: Separator,
                   strip: bool) -> str:
    words_out = []
    for word_node in parse_sexpr(tree_line):
        sylls = []
        for syll_node in word_node[1:]:
            phones = [
                ph_node[0][0].replace('"', "")
                for ph_node in syll_node[1:]
            ]
            syll = separator.phone.join(p for p in phones if p != "")
            sylls.append(syll if strip else syll + separator.phone)
        word = separator.syllable.join(sylls)
        word = word if strip else word + separator.syllable
        if word != "":
            words_out.append(word)
    out = separator.word.join(words_out)
    # strip=False keeps a trailing word separator (festival.py:252)
    return out if strip else out + separator.word


# ---------------------------------------------------------------------------
# phone-list assembly for segments / fallback backends
# ---------------------------------------------------------------------------

def _assemble_words(word_phone_lists: list[list[str]],
                    separator: Separator, strip: bool) -> str:
    words = []
    for phones in word_phone_lists:
        word = separator.phone.join(phones)
        if not strip:
            word += separator.phone
        words.append(word)
    out = separator.word.join(words)
    if not strip and words:
        out += separator.word
    return out


def _chunks(lines: list[str], n: int) -> list[list[str]]:
    """Split ``lines`` into at most ``n`` contiguous chunks (reference
    utils.chunks): order-preserving, sizes as equal as possible."""
    n = max(1, min(n, len(lines)))
    size, rem = divmod(len(lines), n)
    out, pos = [], 0
    for i in range(n):
        take = size + (1 if i < rem else 0)
        out.append(lines[pos : pos + take])
        pos += take
    return [c for c in out if c]


def phonemize(
    text,
    language: str = "en-us",
    backend: str = "espeak",
    separator: Separator = default_separator,
    strip: bool = False,
    preserve_punctuation: bool = False,
    punctuation_marks: str = DEFAULT_MARKS,
    with_stress: bool = False,
    language_switch: str = "keep-flags",
    njobs: int = 1,
    segments_profile: str | None = None,
    espeak_binary: str | None = None,
):
    """Reference-parity multilingual text→phonemes converter
    (phonemizer_api/phonemize.py:31).  ``text`` may be a str (multiline)
    or a list of utterance lines; the return value has the same type.
    """
    if backend not in ("espeak", "festival", "segments", "fallback"):
        raise RuntimeError(
            f"{backend} is not a supported backend, "
            "choose in espeak, festival, segments, fallback."
        )
    if with_stress and backend != "espeak":
        raise RuntimeError(
            'the "with_stress" option is available for espeak backend '
            f"only, but you are using {backend} backend"
        )
    if language_switch != "keep-flags" and backend != "espeak":
        raise RuntimeError(
            'the "language_switch" option is available for espeak '
            f"backend only, but you are using {backend} backend"
        )

    str_input = isinstance(text, str)
    lines = text.splitlines() if str_input else list(text)
    lines = [ln for ln in lines if ln.strip() != ""]

    punct = Punctuation(punctuation_marks)
    if preserve_punctuation:
        chunks, marks = punct.preserve(lines)
    else:
        chunks, marks = punct.remove(lines), []

    # one phonemizable chunk -> phone string, per backend
    if backend == "espeak":
        from .grapheme2phoneme import find_espeak

        binary = espeak_binary or find_espeak()
        if binary is None:
            raise RuntimeError("no espeak/espeak-ng binary found on PATH")

        def one(chunk: str) -> str:
            raw = _espeak_raw(binary, chunk, language)
            return _espeak_postprocess_line(
                raw, separator, strip, with_stress, language_switch
            )
    elif backend == "festival":
        fb = FestivalBackend()

        def one(chunk: str) -> str:
            cleaned = fb._clean_line(chunk)
            if not cleaned:
                return ""
            raw = fb._run(f'"{cleaned}"')
            trees = [
                t for t in raw.split("\n")
                if t not in ("", "(nil nil nil)")
            ]
            if not trees:
                return ""
            return _festival_line(trees[0], separator, strip)
    else:
        if backend == "segments":
            from .grapheme2phoneme import SegmentsBackend

            # profile path wins; otherwise ``language`` may name a
            # bundled profile (reference semantics: language is a
            # supported name or a user g2p file path, segments.py:79).
            be = SegmentsBackend(segments_profile or language)
        else:
            from .grapheme2phoneme import FallbackBackend

            be = FallbackBackend()

        def one(chunk: str) -> str:
            lists = be.word_phone_lists(chunk)
            return _assemble_words(lists, separator, strip)

    def run_lines(ls: list[str]) -> list[str]:
        return [one(c) for c in ls]

    if njobs <= 1 or len(chunks) <= 1:
        phonemized = run_lines(chunks)
    else:
        parts = _chunks(chunks, njobs)
        with ThreadPoolExecutor(max_workers=len(parts)) as ex:
            phonemized = [
                ln for part in ex.map(run_lines, parts) for ln in part
            ]

    # the reference's backends drop chunks that phonemize to nothing
    # BEFORE punctuation restore — restore then realigns on the shorter
    # list.  The drop predicate differs per backend and is semantic:
    # espeak keeps separator-only lines (espeak.py:162 `if line:`),
    # festival strips them (festival.py:129 `line.strip() != ''`).
    if backend == "espeak":
        phonemized = [p for p in phonemized if p]
    else:
        phonemized = [p for p in phonemized if p.strip() != ""]

    if preserve_punctuation:
        phonemized = Punctuation.restore(phonemized, marks)

    return "\n".join(phonemized) if str_input else phonemized


if __name__ == "__main__":  # pragma: no cover — thin delegate
    import sys

    from .__main__ import main

    sys.exit(main())

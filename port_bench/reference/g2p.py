"""Text to phoneme ids, worked out again from the text.

The served system phonemizes with espeak when the binary is installed and
otherwise with a rule-based English letter-to-IPA mapping.  Both are
reproduced here: espeak by running the binary the same way, the rules by
the tables below (a frozen copy of the published mapping).  The ids index
the Tacotron-2 IPA vocabulary: the pad symbol, the sorted IPA inventory,
space and the punctuation espeak keeps.  The benchmark's text is lower
case words separated by single spaces, with no punctuation.
"""

from __future__ import annotations

import re
import shutil
import subprocess

_VOWELS = "iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ"
_NON_PULMONIC = "ʘɓǀɗǃʄǂɠǁʛ"
_PULMONIC = "pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ"
_SUPRASEGMENTALS = "ˈˌːˑ"
_OTHER = "ʍwɥʜʢʡɕʑɺɧ"
_DIACRITICS = "ɚ˞ɫ"
PAD = "_"
PUNCTUATIONS = ".!;:,?"
SYMBOLS = ([PAD] + sorted(_VOWELS + _NON_PULMONIC + _PULMONIC
                          + _SUPRASEGMENTALS + _OTHER + _DIACRITICS)
           + [" "] + list(PUNCTUATIONS))
SYMBOL_ID = {c: i for i, c in enumerate(SYMBOLS)}
N_SYMBOLS = len(SYMBOLS)

_DIGRAPHS = [
    ("tch", "tʃ"), ("sh", "ʃ"), ("ch", "tʃ"), ("th", "θ"), ("ph", "f"),
    ("wh", "w"), ("ng", "ŋ"), ("qu", "kw"), ("ck", "k"), ("oo", "uː"),
    ("ee", "iː"), ("ea", "iː"), ("ou", "aʊ"), ("ow", "aʊ"), ("ai", "eɪ"),
    ("ay", "eɪ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("ar", "ɑː"), ("er", "ɚ"),
    ("or", "ɔː"),
]
_SINGLE = {
    "a": "æ", "b": "b", "c": "k", "d": "d", "e": "ɛ", "f": "f", "g": "ɡ",
    "h": "h", "i": "ɪ", "j": "dʒ", "k": "k", "l": "l", "m": "m", "n": "n",
    "o": "ɒ", "p": "p", "q": "k", "r": "ɹ", "s": "s", "t": "t", "u": "ʌ",
    "v": "v", "w": "w", "x": "ks", "y": "j", "z": "z",
}


def espeak_binary() -> str | None:
    for name in ("espeak-ng", "espeak"):
        path = shutil.which(name)
        if path:
            return path
    return None


def rule_phones(text: str) -> str:
    """The rule-based phone string: each word's letters mapped (longest
    digraph first), a primary stress before the word, words joined by
    spaces, and the trailing word separator."""
    words = []
    for word in text.lower().split():
        out, i = [], 0
        while i < len(word):
            for pat, rep in _DIGRAPHS:
                if word.startswith(pat, i):
                    out.append(rep)
                    i += len(pat)
                    break
            else:
                if word[i] in _SINGLE:
                    out.append(_SINGLE[word[i]])
                i += 1
        if out:
            words.append("ˈ" + "".join(out))
    return " ".join(words) + " "


def espeak_phones(text: str, binary: str) -> str:
    out = subprocess.run([binary, "-q", "--ipa", "-v", "en-us", "--", text],
                         capture_output=True, text=True, check=True).stdout
    out = out.strip().replace("\n", " ").replace("  ", " ")
    out = re.sub(r"\([a-zA-Z][a-zA-Z-]*\)", "", out)
    return out.replace("͡", "").replace("‍", "") + " "


def phoneme_ids(text: str, backend: str = "rules") -> list[int]:
    """``backend``: ``rules`` or ``espeak``, the one the served run
    reports."""
    phones = (espeak_phones(text, espeak_binary()) if backend == "espeak"
              else rule_phones(text))
    return [SYMBOL_ID[c] for c in phones if c in SYMBOL_ID and c != PAD]

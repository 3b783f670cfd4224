"""Standalone command-line phonemizer.

Parity surface for the reference's vendored phonemizer CLI
(msa_tts/utils/g2p/phonemizer_api/main.py): reads utterances from a
file or stdin (one per line), phonemizes them with the chosen backend,
and writes one phonemized line per input line to a file or stdout.

    python -m msa_tts_tpu_torch.utils.g2p "hello world"
    echo "hello world" | python -m msa_tts_tpu_torch.utils.g2p -b espeak -l en-us
    python -m msa_tts_tpu_torch.utils.g2p input.txt -o out.txt -p "-" --strip
    python -m msa_tts_tpu_torch.utils.g2p --list-languages

Also reachable as ``python -m msa_tts_tpu_torch.utils.g2p.phonemize``.
"""

from __future__ import annotations

import argparse
import os
import sys

from .grapheme2phoneme import SegmentsBackend, find_espeak
from .phonemize import Separator, phonemize
from .punctuation import DEFAULT_MARKS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m msa_tts_tpu_torch.utils.g2p",
        description="Multilingual text-to-phonemes converter "
        "(reference phonemizer CLI surface).",
    )
    p.add_argument(
        "input", nargs="?", default=None,
        help="text file to phonemize (one utterance per line), a "
        "literal utterance, or omitted to read stdin",
    )
    p.add_argument("-o", "--output", default=None,
                   help="output file (default: stdout)")
    p.add_argument("-b", "--backend", default=None,
                   choices=["espeak", "festival", "segments",
                            "fallback"],
                   help="default: espeak when a binary is on PATH, "
                   "else fallback")
    p.add_argument("-l", "--language", default="en-us",
                   help="espeak/festival voice, or a segments bundled "
                   "profile name / .g2p file path")
    p.add_argument("--list-languages", action="store_true",
                   help="list bundled segments profiles and exit")
    p.add_argument("-p", "--phone-separator", default="",
                   help="phone boundary token (default: none)")
    p.add_argument("-s", "--syllable-separator", default="",
                   help="syllable boundary token (festival only)")
    p.add_argument("-w", "--word-separator", default=" ",
                   help="word boundary token (default: space)")
    p.add_argument("--strip", action="store_true",
                   help="no trailing separator on words/utterances")
    p.add_argument("--preserve-punctuation", action="store_true")
    p.add_argument("--punctuation-marks", default=DEFAULT_MARKS)
    p.add_argument("--with-stress", action="store_true",
                   help="keep espeak stress marks")
    p.add_argument("--language-switch", default="keep-flags",
                   choices=["keep-flags", "remove-flags",
                            "remove-utterance"])
    p.add_argument("-j", "--njobs", type=int, default=1,
                   help="phonemize in N parallel chunks")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_languages:
        langs = SegmentsBackend.supported_languages()
        for name, path in langs.items():
            print(f"{name}\t{path}")
        return 0

    if args.input is None:
        text = sys.stdin.read()
    elif os.path.isfile(args.input):
        with open(args.input, encoding="utf-8") as f:
            text = f.read()
    else:
        text = args.input

    backend = args.backend
    if backend is None:
        backend = "espeak" if find_espeak() else "fallback"

    out = phonemize(
        text,
        language=args.language,
        backend=backend,
        separator=Separator(
            word=args.word_separator or None,
            syllable=args.syllable_separator or None,
            phone=args.phone_separator or None,
        ),
        strip=args.strip,
        preserve_punctuation=args.preserve_punctuation,
        punctuation_marks=args.punctuation_marks,
        with_stress=args.with_stress,
        language_switch=args.language_switch,
        njobs=args.njobs,
    )
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

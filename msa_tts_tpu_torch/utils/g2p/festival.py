"""Festival phonemization backend.

Shells out to the ``festival`` text-to-speech system in batch mode,
asking it to print each utterance's "SylStructure" relation tree (a
Scheme expression), then parses that tree back into phone strings —
the same protocol as the reference's vendored backend
(msa_tts/utils/g2p/phonemizer_api/backend/festival.py:1,
lispy.py, share/festival/phonemize.scm).

Festival emits its own phone set (US English arpabet-ish names such as
``hh ax l ow``), not IPA — per word the phones concatenate directly and
words join with spaces, matching the reference's default Separator
(word=" ", syllable="", phone="").  Only ``en-us`` is supported, as in
the reference.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile

# Scheme program sent to festival: load a file of double-quoted lines,
# synthesize each, print one SylStructure tree per line.  ``{}`` is
# replaced with the temp file holding the quoted input lines.
_SCM_TEMPLATE = """\
(define (phonemize-line line)
  (set! utt (eval (list 'Utterance 'Text line)))
  (utt.synth utt)
  (print (utt.relation_tree utt "SylStructure")))
(set! input-lines (load "{}" t))
(mapcar (lambda (line) (phonemize-line line)) input-lines)
"""


def find_festival() -> str | None:
    """Locate the festival binary: ``PHONEMIZER_FESTIVAL_PATH`` env var
    first (must be executable), then PATH."""
    env = os.environ.get("PHONEMIZER_FESTIVAL_PATH")
    if env:
        if not (os.path.isfile(env) and os.access(env, os.X_OK)):
            raise ValueError(
                f"PHONEMIZER_FESTIVAL_PATH={env} is not an executable file"
            )
        return os.path.abspath(env)
    return shutil.which("festival")


def parse_sexpr(text: str):
    """Parse one Scheme expression into nested lists of token strings.
    Raises IndexError on unbalanced parentheses (matching the vendored
    parser's contract)."""
    tokens = text.replace("(", " ( ").replace(")", " ) ").split()
    pos = 0

    def read():
        nonlocal pos
        tok = tokens[pos]
        pos += 1
        if tok == "(":
            node = []
            while tokens[pos] != ")":
                node.append(read())
            pos += 1
            return node
        if tok == ")":
            raise SyntaxError("unexpected )")
        return tok

    if not tokens:
        raise SyntaxError("empty expression")
    return read()


class FestivalBackend:
    """Subprocess wrapper satisfying the same ``phonemize_chunk``
    protocol as the other G2P backends."""

    def __init__(self, binary: str | None = None):
        self.binary = binary or find_festival()
        if self.binary is None:
            raise RuntimeError("no festival binary found on PATH")

    @classmethod
    def is_available(cls) -> bool:
        try:
            return find_festival() is not None
        except ValueError:
            return False

    def version(self) -> str:
        out = subprocess.check_output(
            [self.binary, "--version"]
        ).decode("latin1").strip()
        m = re.match(r".* ([0-9.]+[0-9]):", out)
        if not m:
            raise RuntimeError(f"cannot parse festival version: {out!r}")
        return m.group(1)

    @staticmethod
    def supported_languages() -> dict:
        return {"en-us": "english-us"}

    # ------------------------------------------------------------- pipeline
    @staticmethod
    def _clean_line(line: str) -> str:
        """Strip characters that break the Scheme wrapping: double
        quotes delimit utterances and parens are Scheme syntax.  A line
        of only apostrophes crashes festival outright."""
        if line and set(line) == {"'"}:
            return ""
        return (
            line.replace('"', "").replace("(", "").replace(")", "").strip()
        )

    def _run(self, quoted_lines: str) -> str:
        data = tempfile.NamedTemporaryFile("w+", delete=False)
        scm = tempfile.NamedTemporaryFile("w+", delete=False)
        try:
            data.write(quoted_lines)
            data.close()
            scm.write(_SCM_TEMPLATE.format(data.name))
            scm.close()
            out = subprocess.run(
                [self.binary, "-b", scm.name],
                capture_output=True, check=True,
            ).stdout
            # festival speaks latin-1, and pads with double spaces
            return re.sub(" +", " ", out.decode("latin1"))
        except subprocess.CalledProcessError as err:
            raise RuntimeError(
                f"festival failed (exit {err.returncode}): "
                f"{err.stderr.decode('latin1', 'replace')[-500:]}"
            ) from err
        finally:
            os.unlink(data.name)
            os.unlink(scm.name)

    @staticmethod
    def tree_to_phones(tree_line: str) -> str:
        """One printed SylStructure tree → "phones phones ..." with
        phones concatenated per word and words space-joined (the
        reference's default separator), plus the trailing word
        separator (strip=False semantics)."""
        words = []
        for word_node in parse_sexpr(tree_line):
            sylls = []
            for syll_node in word_node[1:]:
                phones = [
                    ph_node[0][0].replace('"', "")
                    for ph_node in syll_node[1:]
                ]
                sylls.append("".join(p for p in phones if p))
            word = "".join(sylls)
            if word:
                words.append(word)
        return " ".join(words) + " " if words else ""

    def phonemize_lines(self, lines: list[str]) -> list[str]:
        cleaned = [self._clean_line(x) for x in lines if x != ""]
        payload = "\n".join(f'"{x}"' for x in cleaned if x != "")
        if not payload:
            return []
        raw = self._run(payload)
        out = [
            self.tree_to_phones(line)
            for line in raw.split("\n")
            if line not in ("", "(nil nil nil)")
        ]
        return [x for x in out if x.strip() != ""]

    def phonemize_chunk(self, text: str, language: str = "en-us") -> str:
        if language not in self.supported_languages():
            raise RuntimeError(
                f"festival supports only {list(self.supported_languages())},"
                f" got {language!r}"
            )
        lines = self.phonemize_lines([text])
        return lines[0].strip() if lines else ""

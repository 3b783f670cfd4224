"""Punctuation hiding/restoration around phonemization backends.

Phonemization engines drop punctuation (espeak, festival) or choke on
it (segments).  This module removes the marks before the backend runs
and splices them back afterwards, byte-compatibly with the reference's
vendored ``phonemizer_api/punctuation.py`` (differentially tested in
tests/test_g2p.py::test_punctuation_matches_reference).

The preserve/restore contract:

    preserve(["hello, my world!"]) -> (["hello", "my world"],
                                       [Mark(0, ", ", "I"),
                                        Mark(0, "!", "E")])
    restore(["həloʊ ", "maɪ wɜːld "], marks) -> ["həloʊ , maɪ wɜːld !"]

A ``Mark`` records the line it came from, the exact matched run
(including surrounding whitespace) and where it sat: ``B``\\egin,
``E``\\nd, ``I``\\nside, or ``A``\\lone (the whole line was marks).
"""

from __future__ import annotations

import re
from typing import NamedTuple

DEFAULT_MARKS = ';:,.!?¡¿—…"«»“”'


class Mark(NamedTuple):
    index: int      # input line number
    mark: str       # the matched run, whitespace included
    position: str   # 'B' | 'E' | 'I' | 'A'


class Punctuation:
    """Hide punctuation from a backend, then restore it."""

    def __init__(self, marks: str = DEFAULT_MARKS):
        if not isinstance(marks, str):
            raise ValueError("punctuation marks must be a string")
        # de-duplicate (order-insensitive, it only feeds a char class)
        self.marks = "".join(set(marks))
        self._marks_re = re.compile(rf"(\s*[{re.escape(self.marks)}]+\s*)+")

    def remove(self, text):
        """Replace every punctuation run with a single space."""
        if isinstance(text, str):
            return self._marks_re.sub(" ", text).strip()
        return [self._marks_re.sub(" ", line).strip() for line in text]

    def preserve(self, text):
        """Strip marks out of ``text`` (a string or list of lines),
        returning ``(chunks, marks)`` such that ``restore`` inverts it."""
        lines = text.strip().split("\n") if isinstance(text, str) else text
        chunks: list[str] = []
        marks: list[Mark] = []
        for num, line in enumerate(lines):
            line_chunks, line_marks = self._preserve_line(line, num)
            chunks += [c for c in line_chunks if c]
            marks += line_marks
        return chunks, marks

    def _preserve_line(self, line: str, num: int):
        matches = list(self._marks_re.finditer(line))
        if not matches:
            return [line], []
        if len(matches) == 1 and matches[0].group() == line:
            # the line is nothing but marks
            return [], [Mark(num, line, "A")]

        marks = []
        for m in matches:
            if m is matches[0] and line.startswith(m.group()):
                pos = "B"
            elif m is matches[-1] and line.endswith(m.group()):
                pos = "E"
            else:
                pos = "I"
            marks.append(Mark(num, m.group(), pos))

        # peel the line apart mark by mark (split on the FIRST occurrence
        # of each matched run; later identical runs stay in the suffix)
        chunks = []
        rest = line
        for mk in marks:
            head, _, tail = rest.partition(mk.mark)
            chunks.append(head)
            rest = tail
        return chunks + [rest], marks

    @classmethod
    def restore(cls, text, marks):
        """Inverse of ``preserve``: splice ``marks`` back between the
        (phonemized) ``chunks`` and return the restored lines."""
        chunks = list(text.strip().split("\n")) if isinstance(text, str) \
            else list(text)
        marks = list(marks)
        out: list[str] = []
        num = 0
        while marks:
            mk = marks[0]
            if mk.index != num:
                # no mark belongs to this line; emit it as-is
                out.append(chunks.pop(0))
                num += 1
            elif mk.position == "B":
                chunks[0] = mk.mark + chunks[0]
                marks.pop(0)
            elif mk.position == "E":
                out.append(chunks.pop(0) + mk.mark)
                marks.pop(0)
                num += 1
            elif mk.position == "A":
                out.append(mk.mark)
                marks.pop(0)
                num += 1
            else:  # 'I'
                if len(chunks) == 1:
                    # the tail after this mark produced no phonemes
                    chunks[0] = chunks[0] + mk.mark
                else:
                    head = chunks.pop(0)
                    chunks[0] = head + mk.mark + chunks[0]
                marks.pop(0)
        return out + chunks

from .char_list import char_list, CHAR_TO_ID, ID_TO_CHAR, N_SYMBOLS
from .grapheme2phoneme import Grapheme2Phoneme

__all__ = [
    "char_list",
    "CHAR_TO_ID",
    "ID_TO_CHAR",
    "N_SYMBOLS",
    "Grapheme2Phoneme",
]

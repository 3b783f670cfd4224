"""Phoneme vocabulary.

The symbol inventory must match the reference framework exactly
(reference: msa_tts/utils/g2p/char_list.py:3-15) so that pre-phonemized
metafiles and imported checkpoints keep their meaning: the vocabulary is
the sorted IPA symbol set (vowels, consonants, suprasegmentals,
diacritics) preceded by the pad symbol and followed by space and the
punctuation that espeak preserves.
"""

# IPA inventory (standard IPA symbol groups).
_VOWELS = "iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ"
_NON_PULMONIC_CONSONANTS = "ʘɓǀɗǃʄǂɠǁʛ"
_PULMONIC_CONSONANTS = (
    "pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ"
)
_SUPRASEGMENTALS = "ˈˌːˑ"
_OTHER_SYMBOLS = "ʍwɥʜʢʡɕʑɺɧ"
_DIACRITICS = "ɚ˞ɫ"

_phonemes = sorted(
    _VOWELS
    + _NON_PULMONIC_CONSONANTS
    + _PULMONIC_CONSONANTS
    + _SUPRASEGMENTALS
    + _OTHER_SYMBOLS
    + _DIACRITICS
)

PAD = "_"
SPACE = " "
# Punctuation kept by the espeak engine after phonemization.
PUNCTUATIONS = ".!;:,?"

char_list = [PAD] + _phonemes + [SPACE] + list(PUNCTUATIONS)

CHAR_TO_ID = {c: i for i, c in enumerate(char_list)}
ID_TO_CHAR = {i: c for i, c in enumerate(char_list)}

N_SYMBOLS = len(char_list)

if __name__ == "__main__":
    print(f"Char list ({N_SYMBOLS}):\n{char_list}")

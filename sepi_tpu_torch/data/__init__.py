from .manifest import Dataset, Trial, Utterance
from .synthetic import PhoneticCorpus, SyntheticCorpus, make_phonetic_corpus, make_synthetic_corpus

__all__ = [
    "Dataset",
    "PhoneticCorpus",
    "SyntheticCorpus",
    "Trial",
    "Utterance",
    "make_phonetic_corpus",
    "make_synthetic_corpus",
]

from .manifest import Dataset, Trial, Utterance
from .synthetic import SyntheticCorpus, make_synthetic_corpus

__all__ = ["Dataset", "SyntheticCorpus", "Trial", "Utterance", "make_synthetic_corpus"]

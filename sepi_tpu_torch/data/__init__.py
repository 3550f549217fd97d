from .featstore import PrefetchLoader
from .manifest import Dataset, Trial, Utterance
from .sampler import (ChunkBatch, ChunkSampler, FrameBatch, FrameSampler, MultitaskInterleaver,
                      bucket_lengths, diagnostic_lengths)
from .synthetic import PhoneticCorpus, SyntheticCorpus, make_phonetic_corpus, make_synthetic_corpus

__all__ = [
    "ChunkBatch",
    "ChunkSampler",
    "Dataset",
    "FrameBatch",
    "FrameSampler",
    "MultitaskInterleaver",
    "PrefetchLoader",
    "bucket_lengths",
    "diagnostic_lengths",
    "PhoneticCorpus",
    "SyntheticCorpus",
    "Trial",
    "Utterance",
    "make_phonetic_corpus",
    "make_synthetic_corpus",
]

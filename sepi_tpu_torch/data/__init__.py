from .audio import AudioStore, ChainAudio, LazyAudio, extract_segments, read_audio, read_wav, write_wav
from .corpora import (dataset_from_kaldi_dir, dataset_from_table, dataset_from_wav_tree,
                      write_kaldi_dir)
from .featstore import FeatStore, PrefetchLoader
from .manifest import Dataset, Trial, Utterance, load_trials, save_trials
from .sampler import (ChunkBatch, ChunkSampler, FrameBatch, FrameSampler, MultitaskInterleaver,
                      bucket_lengths, diagnostic_lengths)
from .synthetic import (PhoneticCorpus, SyntheticCorpus, make_phonetic_corpus,
                        make_phonetic_corpus_v2, make_synthetic_corpus)

__all__ = [
    "AudioStore",
    "ChainAudio",
    "ChunkBatch",
    "ChunkSampler",
    "Dataset",
    "FeatStore",
    "FrameBatch",
    "FrameSampler",
    "LazyAudio",
    "MultitaskInterleaver",
    "PrefetchLoader",
    "bucket_lengths",
    "dataset_from_kaldi_dir",
    "dataset_from_table",
    "dataset_from_wav_tree",
    "diagnostic_lengths",
    "extract_segments",
    "load_trials",
    "PhoneticCorpus",
    "read_audio",
    "read_wav",
    "save_trials",
    "SyntheticCorpus",
    "Trial",
    "Utterance",
    "make_phonetic_corpus",
    "make_phonetic_corpus_v2",
    "make_synthetic_corpus",
    "write_kaldi_dir",
    "write_wav",
]

"""The operation and byte counts of the roofline and MFU metrics, held
against counts made by hand at small shapes."""

import json

import pytest

import tiny
from harness import flops
from reference.extract import chunks

SRE = json.load(open(f"{tiny.BENCH}/configs/xvector_v2.json"))["frontend"]


def test_stack_flops_by_hand():
    # 10 frames in, 2 channels -> 4 channels over offsets -1..1 (8 frames out),
    # then 4 -> 3 over one tap: 2*8*2*3*4 + 2*8*4*1*3
    f, frames, dim = flops.stack_flops([[4, [-1, 0, 1]], [3, [0]]], 2, 10)
    assert (f, frames, dim) == (384.0 + 192.0, 8, 3)


def test_embed_flops_of_the_xvector_by_hand():
    cfg = {"model": "xvector", "feat_dim": 2, "embed_dim": 5,
           "arch": {"frames": {"layers": [[4, [-1, 0, 1]], [3, [0]]]}}}
    # the trunk as above on 10 frames, then tdnn6's affine on 2 x 3 pooled stats
    assert flops.embed_flops(cfg, 10) == 576.0 + 2 * 6 * 5


def test_embed_flops_of_the_combined_model_by_hand():
    cfg = {"model": "combined", "feat_dim": 2, "embed_dim": 5, "pool_dim": 7,
           "arch": {"shared": {"layers": [[4, [-1, 0, 1]]]},
                    "xvec_branch": {"layers": [[4, [0]]]},
                    "am": {"layers": [[3, [-2, 0]]]}}}
    # 10 frames: shared 8 out (2*8*2*3*4 = 384), xvec branch 8 (2*8*4*4 = 256),
    # am 8 out (2*8*2*2*3 = 192); merged: contexts (1, 1) and (2, 0) -> 10 - 2 - 1 = 7
    # frames of 4 + 3 channels into 7 (2*7*7*7 = 686); tdnn6 2*14*5 = 140
    assert flops.embed_flops(cfg, 10) == 384 + 256 + 192 + 686 + 140


def test_train_forward_flops_by_hand():
    cfg = {"model": "combined", "feat_dim": 2, "embed_dim": 5, "pool_dim": 7,
           "num_senones": 11, "num_speakers": 13,
           "arch": {"shared": {"layers": [[4, [-1, 0, 1]]]},
                    "am_branch": {"layers": [[6, [0]]]},
                    "xvec_branch": {"layers": [[4, [0]]]},
                    "am": {"layers": [[3, [-2, 0]]]}}}
    # am task, batch 2 of 10 frames: shared 384, branch 2*8*4*6 = 384, logits 2*8*6*11
    assert flops.train_forward_flops(cfg, "am", 2, 10) == 2 * (384 + 384 + 1056)
    # xvec task: trunk 384 + 256 + 192 + 686, head 2*(14*5 + 5*5 + 5*13)
    assert flops.train_forward_flops(cfg, "xvec", 2, 10) == 2 * (1518 + 320)


def test_train_forward_flops_of_the_xvector_by_hand():
    cfg = {"model": "xvector", "feat_dim": 2, "embed_dim": 5, "num_speakers": 13,
           "arch": {"frames": {"layers": [[4, [-1, 0, 1]], [3, [0]]]}}}
    # batch 2 of 10 frames: the trunk 576 (above), head 2*(2*3*5 + 5*5 + 5*13)
    assert flops.train_forward_flops(cfg, "xvec", 2, 10) == 2 * (576 + 240)


def test_mfcc_counts_by_hand():
    # framing 8 x 200, real FFT 2.5 x 256 x 8, power 3 x 129, mel 2 x 224
    # nonzero weights, log 23, DCT 2 x 23 x 23, lifter 23
    assert flops.mfcc_ops_per_frame(SRE) == 1600 + 5120 + 387 + 448 + 23 + 1058 + 23
    assert flops.mfcc_bytes(8000, 100, SRE) == 4 * 8000 + 100 * (4 * 23 + 1)


@pytest.mark.parametrize("frames", [14, 25, 26, 9999, 10000, 10024, 10025, 23456])
def test_the_reference_cuts_chunks_as_the_program_does(frames):
    from sepi_tpu_torch.config import ExtractConfig
    from sepi_tpu_torch.extract import chunk_spans

    ext = {"min_chunk_size": 25, "chunk_size": 10000, "min_frames": 15}
    assert chunks(frames, ext) == chunk_spans(frames, ExtractConfig(), 15)

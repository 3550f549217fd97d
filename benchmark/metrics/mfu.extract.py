"""mfu.extract: the forward flops of the embeddings' real chunk frames
(padding rows and frames excluded; `harness.flops.embed_flops`) per
second of the window, as a share of the TF32 tensor-core peak (the
highest rate for float32 inputs, so a 3xTF32 or fp32 product cannot
read over 100%).  The card's power limit is on the result's device."""


def read(out, cell, peaks):
    if peaks is None or out.window_s <= 0:
        return None
    return 100.0 * out.work["embed_flops"] / out.window_s / peaks["tf32_flops"]

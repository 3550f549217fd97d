"""conv_pct.extract: the share of the traced busy time spent in
convolution and matrix-product kernels (cuDNN's forward convolutions,
implicit-GEMM, Winograd and FFT ones; cuBLAS and CUTLASS GEMM and GEMV),
by kernel name.  High, the model's products set the card's pace; low, its
elementwise passes (masks, batch norm, SE scaling, the softmax), the
frontend or the copies do."""

NEEDLES = ("gemm", "gemv", "fprop", "convolve", "winograd", "fft")


def read(out, cell, peaks):
    if out.trace is None or out.trace.busy_s <= 0 or out.trace.device_events == 0:
        return None
    conv = sum(s for n, s in out.trace.kernels.items() if any(k in n.lower() for k in NEEDLES))
    return 100.0 * conv / out.trace.busy_s

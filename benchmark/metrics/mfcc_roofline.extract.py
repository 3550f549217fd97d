"""mfcc_roofline.extract: the MFCC kernel's share of its roofline.

The least time the card could take for the window's real frames (the
larger of `harness.flops.mfcc_ops_per_frame` x frames at the TF32 peak
and `mfcc_bytes` at the HBM peak) over the device time of every launch of
`mfcc_kernel` in the trace."""

from harness.flops import mfcc_bytes, mfcc_ops_per_frame


def read(out, cell, peaks):
    if out.trace is None or peaks is None:
        return None
    t = out.trace.kernel_seconds("mfcc_kernel")
    if t <= 0:
        return None
    fcfg = cell.config["frontend"]
    ops = mfcc_ops_per_frame(fcfg) * out.work["mfcc_frames"]
    byts = mfcc_bytes(out.work["samples"], out.work["mfcc_frames"], fcfg)
    bound = max(ops / peaks["tf32_flops"], byts / peaks["hbm_bytes_per_s"])
    return 100.0 * bound / t

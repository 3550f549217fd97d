"""mfu.train: 3 x the forward flops of every step the window completed
(each unit's task and batch shape; `harness.flops.train_forward_flops`)
per second of the window, as a share of the bf16 dense peak.  The card's
power limit is on the result's device."""


def read(out, cell, peaks):
    if peaks is None or out.window_s <= 0 or not out.work.get("steps"):
        return None
    return 100.0 * out.work["train_flops"] / out.window_s / peaks["bf16_flops"]

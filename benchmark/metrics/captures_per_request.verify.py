"""captures_per_request.verify: inference graphs the program captured in
the window (`sepi_tpu_torch.graphs.call_counts["captures"]`, read before
and after), per request."""


def read(out, cell, peaks):
    n = out.work.get("requests", 0)
    if not n or "captures" not in out.work:
        return None
    return out.work["captures"] / n

"""frontend_ms.verify: milliseconds a request spends in
`prepare_features_nosil` (the harness's span), over the window's requests."""


def read(out, cell, peaks):
    n = out.work.get("requests", 0)
    if out.spans is None or not n or "frontend" not in out.spans.totals:
        return None
    return 1e3 * out.spans.seconds("frontend") / n

"""frontend_pct.extract: the share of the window spent in
`prepare_features_nosil` (host batching, the frontend graphs, the copies
back), from the harness's span around each call."""


def read(out, cell, peaks):
    if out.spans is None or out.window_s <= 0 or "frontend" not in out.spans.totals:
        return None
    return 100.0 * out.spans.seconds("frontend") / out.window_s

"""embed_ms.verify: milliseconds a request spends in the service's
`EmbeddingExtractor.extract_utterances` (the harness's span), over the
window's requests."""


def read(out, cell, peaks):
    n = out.work.get("requests", 0)
    if out.spans is None or not n or "embed" not in out.spans.totals:
        return None
    return 1e3 * out.spans.seconds("embed") / n

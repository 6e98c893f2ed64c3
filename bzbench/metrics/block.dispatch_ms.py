"""block.dispatch_ms: the dispatchers' host ms a device block, in
``transform``/``transform_bwt`` and ``fetch_async``/``fetch_bwt_async``
(wrapped from the benchmark), over the window's blocks (one
``bwt_forward_async`` call each)."""


def read(run):
    if run.probe is None:
        return None
    spans, blocks = run.probe.spans.get("dispatch", []), len(run.probe.spans.get("bwt", []))
    if not spans or not blocks:
        return None
    return 1000.0 * sum(b - a for a, b, _ in spans) / blocks

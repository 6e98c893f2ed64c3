"""emit.ms_per_block: host ms a block in ``emit_block`` (the native
refinement and emission on an emit thread), wrapped, over the window."""


def read(run):
    spans = run.probe.spans.get("emit", []) if run.probe is not None else []
    if not spans:
        return None
    return 1000.0 * sum(b - a for a, b, _ in spans) / len(spans)

"""host_mtf_rle2.ms_per_block: host ms a block in the bwt stage's
``mtf_rle2_native`` on an emit thread, wrapped, over the window. Nothing to
read on the full stage."""


def read(run):
    spans = run.probe.spans.get("host_mtf_rle2", []) if run.probe is not None else []
    if not spans:
        return None
    return 1000.0 * sum(b - a for a, b, _ in spans) / len(spans)

"""capture_s (pipeline, core/pipeline.py): seconds the CUDA graphs' captures
and instantiations took, both kinds of block (warm-up and train)."""


def read(ctx):
    graphs = ctx["summary"].get("graphs") or {}
    if not graphs:
        return None
    return sum(g["capture_seconds"] + g["instantiate_seconds"] for g in graphs.values())

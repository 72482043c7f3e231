"""entity_attn_roofline (kernels, csrc/entity_attn.cu via ops/entity_attn.py):
the summed least time of a train block's entity-attention calls (their
shapes from the configuration, benchmark/costs.py) over the device time of
those calls' kernels in the traced blocks, in percent. A call's kernels are
its stages, found around the call's own kernel in time order. Raises where
the traced calls are not the ones the configuration gives."""
from benchmark import costs, trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    per_block = costs.launches_per_block(ctx["sizes"])
    seconds = 0.0
    for call, launches in (("attn_fwd", "entity_attn_fwd"), ("attn_bwd", "entity_attn_bwd")):
        s, n = trace.call_seconds(tr, call)
        if n != per_block[launches] * tr.blocks:
            raise RuntimeError(f"entity_attn_roofline: {n} {call} calls traced in {tr.blocks} "
                               f"blocks; the configuration gives {per_block[launches]} a block")
        seconds += s
    bound_s = costs.block_bound_ms(ctx["sizes"], ctx["dtype"])["attention"] / 1e3 * tr.blocks
    return 100.0 * bound_s / seconds

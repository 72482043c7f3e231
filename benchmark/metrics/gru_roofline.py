"""gru_roofline (kernels, csrc/gru.cu via ops/gru_kernel.py): the summed least
time of a train block's GRU calls (their shapes from the configuration,
benchmark/costs.py) over the device time of those calls' kernels in the
traced blocks, in percent. Raises where the traced calls are not the ones
the configuration gives."""
from benchmark import costs, trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    per_block = costs.launches_per_block(ctx["sizes"])
    seconds = 0.0
    for call, launches in (("gru_fwd", "gru_fwd"), ("gru_bwd", "gru_bwd")):
        s, n = trace.call_seconds(tr, call)
        if n != per_block[launches] * tr.blocks:
            raise RuntimeError(f"gru_roofline: {n} {call} calls traced in {tr.blocks} "
                               f"blocks; the configuration gives {per_block[launches]} a block")
        seconds += s
    bound_s = costs.block_bound_ms(ctx["sizes"], ctx["dtype"])["gru"] / 1e3 * tr.blocks
    return 100.0 * bound_s / seconds

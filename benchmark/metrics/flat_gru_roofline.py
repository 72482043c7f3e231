"""flat_gru_roofline (GRU kernels, csrc/gru.cu via ops/gru_kernel.py, at the
flat path's calls): the summed least time of a QMIX train block's GRU calls
(their shapes from the configuration, benchmark/costs_flat.py) over the
device time of those calls' kernels in the traced blocks, in percent.
Raises where the traced calls are not the ones the configuration gives."""
from benchmark import costs_flat, trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    per_block = costs_flat.launches_per_block(ctx["sizes"])
    seconds = 0.0
    for call in ("gru_fwd", "gru_bwd"):
        s, n = trace.call_seconds(tr, call)
        if n != per_block[call] * tr.blocks:
            raise RuntimeError(f"flat_gru_roofline: {n} {call} calls traced in {tr.blocks} "
                               f"blocks; the configuration gives {per_block[call]} a block")
        seconds += s
    return 100.0 * costs_flat.block_bound_ms(ctx["sizes"]) / 1e3 * tr.blocks / seconds

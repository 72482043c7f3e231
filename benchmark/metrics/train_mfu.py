"""train_mfu (whole step): the model operations of the window's train blocks
(benchmark/costs.py, block_model_flops: none recomputed) over the window's
wall seconds, over the card's peak for the configuration's dtype, in
percent."""
from benchmark import costs


def read(ctx):
    if not ctx["on_card"]:
        return None
    rate = costs.block_model_flops(ctx["sizes"]) * ctx["window_blocks"] / ctx["window_seconds"]
    return 100.0 * rate / costs.PEAK_FLOPS[ctx["dtype"]]

"""flat_train_mfu (whole step): the model operations of the window's QMIX
train blocks (benchmark/costs_flat.py, block_model_flops: none recomputed)
over the window's wall seconds, over the card's peak for the
configuration's dtype, in percent. Every update counts its episodes at
T = episode_limit + 1, the padded steps after an episode's end included
(the block trains at that fixed T), so the share overstates the work on
filled steps by the ratio of the episode limit to the episodes' length."""
from benchmark import costs, costs_flat


def read(ctx):
    if not ctx["on_card"]:
        return None
    rate = costs_flat.block_model_flops(ctx["sizes"]) * ctx["window_blocks"] / ctx["window_seconds"]
    return 100.0 * rate / costs.PEAK_FLOPS[ctx["dtype"]]

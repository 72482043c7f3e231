"""The call shapes the benchmark derives from a configuration
(``costs.block_calls``) against the calls the port's ops receive in one train
block of a CPU run of that configuration, cut down, recorded by wrapping the
ops from outside."""
import collections
import time

import pytest
import torch

from benchmark import costs, harness
from benchmark.tests.tiny import tiny_spec


@pytest.mark.parametrize("workload", ["refil_sz.b8", "refil_sz_bf16.b4096",
                                      "refil_sz_bf16.b512_test"])
def test_block_calls_match_the_ops(monkeypatch, workload):
    from refil_torch.core.pipeline import FusedPipeline
    from refil_torch.modules import layers

    spec = tiny_spec(workload)
    sizes = harness.cell_sizes(spec["config"], spec["traffic"])
    seen = {"attention": collections.Counter(), "gru": collections.Counter()}
    state = {"in_block": False, "blocks": 0}

    def attention(entities, in_kernel, *args):
        if state["in_block"]:
            post_mask = args[-2]
            key = (entities.shape[0], entities.shape[1], post_mask.shape[1], in_kernel.shape[0])
            seen["attention"][key + (False,)] += 1
            if torch.is_grad_enabled() and (entities.requires_grad or in_kernel.requires_grad):
                seen["attention"][key + (True,)] += 1
        return attn_orig(entities, in_kernel, *args)

    def gru(xw, wh, bhn, h0):
        if state["in_block"]:
            key = (xw.shape[0], xw.shape[1])
            seen["gru"][key + (False,)] += 1
            if torch.is_grad_enabled() and (xw.requires_grad or wh.requires_grad):
                seen["gru"][key + (True,)] += 1
        return gru_orig(xw, wh, bhn, h0)

    def block_device(self, ps, train=True):
        state["in_block"] = train and state["blocks"] == 0
        try:
            return block_orig(self, ps, train)
        finally:
            state["blocks"] += int(train)
            state["in_block"] = False

    attn_orig, gru_orig = layers.kernel_entity_attention, layers.kernel_gru_sequence
    block_orig = FusedPipeline.block_device
    monkeypatch.setattr(layers, "kernel_entity_attention", attention)
    monkeypatch.setattr(layers, "kernel_gru_sequence", gru)
    monkeypatch.setattr(FusedPipeline, "block_device", block_device)
    harness.run_cell(workload, 7, 0.0, False, time.perf_counter(), device="cpu", spec=spec)

    calls = costs.block_calls(sizes)
    want_attn, want_gru = collections.Counter(), collections.Counter()
    for c in calls["attention"]:
        want_attn[(c.Bp, c.Ne, c.Nq, c.width, c.bwd)] += c.count
    for c in calls["gru"]:
        want_gru[(c.T, c.R, c.bwd)] += c.count
    assert seen["attention"] == want_attn
    assert seen["gru"] == want_gru

"""The benchmark's operation and byte counters against shapes worked by hand."""
import pytest

from benchmark import costs, harness


def test_attention_cost_by_hand():
    # Bp 2, Ne 3, Nq 2, D = E = O = 4, float32 (4 bytes)
    # weights (4*12 + 4*4 + 4) * 4 = 272; masks 2*2*3 + 2*2 = 16
    # forward: reads 2*3*4*4 = 96 + 272 + 16, writes 2*2*4*4 = 64 -> 448 bytes;
    # q|k|v 2*2*(3*8 + 2*4)*4 = 512, scores 4*2*2*3*4 = 192, out 2*2*2*4*4 = 128
    assert costs.attention_cost(2, 3, 2, 4, 4, 4, "float32", False) == (448, 832)
    # backward: reads 96 + 64 + 272 + 16 = 448, writes 96 + 272 = 368;
    # 512 + 192 + 2*128 + 2*192 + 2*512 = 2368
    assert costs.attention_cost(2, 3, 2, 4, 4, 4, "float32", True) == (816, 2368)
    # bfloat16 halves the entities, outputs and weights read, not the masks
    assert costs.attention_cost(2, 3, 2, 4, 4, 4, "bfloat16", False)[0] == (48 + 136 + 16 + 32)


def test_gru_cost_by_hand():
    # T 2, R 3, H 2: weights (2*6 + 2)*4 = 56; product 2*2*3*2*6 = 144
    # forward: xw 2*3*6*4 = 144 + 56 + h0 3*2*4 = 24 + hs 2*3*2*4 = 48
    assert costs.gru_cost(2, 3, 2, "float32", False) == (272, 144)
    # backward: reads 144 + 96 + 24 + 56, writes 144 + 56 + 24; 3 products
    assert costs.gru_cost(2, 3, 2, "float32", True) == (544, 432)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert costs.bound_ms(3.35e9, 0, "float32") == pytest.approx(1.0)
    assert costs.bound_ms(0, 67e9, "float32") == pytest.approx(1.0)
    assert costs.bound_ms(3.35e9, 989e9 * 2, "bfloat16") == pytest.approx(2.0)


@pytest.mark.parametrize("workload", ["refil_sz.b8", "refil_sz_bf16.b4096",
                                      "refil_sz_bf16.b512_test"])
def test_launches_per_block_match_the_graphs(workload):
    """A train block's launches as the port's captured train graph records
    them on the card (the run's `graphs` summary): 15 attention forwards and
    10 backwards, 2 GRU forwards and 1 backward an update, one attention and
    one GRU forward a rollout step."""
    spec = harness.load_cell(workload)
    sizes = harness.cell_sizes(spec["config"], spec["traffic"])
    assert costs.launches_per_block(sizes) == {
        "entity_attn_fwd": 270, "entity_attn_bwd": 80, "gru_fwd": 166, "gru_bwd": 8}


def test_model_flops_by_hand():
    sizes = {"batch_size_run": 1, "batch_size": 1, "episode_limit": 1, "n_agents": 1,
             "n_entities": 2, "entity_shape": 1, "n_actions": 1, "attn_embed_dim": 2,
             "rnn_hidden_dim": 1, "hypernet_embed": 2, "mixing_embed_dim": 1,
             "training_iters": 1, "attn_n_heads": 1}
    # agent over n rows: fc1 2n*2*2*2 = 16n; attention (Bp n, Ne 2, Nq 1, widths 2):
    # 2n(2*4 + 2)*2 + 4n*2*2 + 2n*2*2 = 40n + 16n + 8n = 64n;
    # fc2 + GRU + fc3: 2n(2 + 6 + 1) = 18n -> 98n, first layer 16n
    # hypernet over n rows: fc1 16n + attention 64n + fc2 2n*2 = 84n, first 16n
    rollout = 98
    agent = 3 * 2 * 98 * 3 - 3 * 2 * 16  # x3 over 2 steps, forward and backward
    target_agent = 2 * 98
    mixing = 2 * (1 + 1) + 2 * (2 + 1)
    live_mixer = 3 * (9 * 84 + mixing) - 9 * 16
    target_mixer = 4 * 84 * 2 + 2 * 2 * 2
    assert costs.block_model_flops(sizes) == rollout + agent + target_agent + live_mixer + \
        target_mixer

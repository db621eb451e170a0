"""Operation and byte counts against hand counts at tiny shapes."""
import torch

from portbench.harness import counts, peaks
from portbench.reference import unise


def test_owner_call_by_hand():
    # 10 live rows of 2 heads x 4 in bf16, K and V: 320 B; q and out of 2
    # slots: 64 B; starts and positions: 16 B; 4 ops per row, head, dim
    assert counts.owner_call(10, 2, 2, 4, 2) == (400, 320)


def test_vq_call_by_hand():
    # x 3 x 2, one codebook 5 x 2, 3 codes, fp32: 76 B; 3 x 2 M N D
    assert counts.vq_call(3, 5, 2, 1) == (76, 180)


def test_bound_takes_the_larger():
    t, by = peaks.bound_s(3.35e12, 1.0, "bf16")
    assert by == "bytes" and abs(t - 1.0) < 1e-12
    t, by = peaks.bound_s(1.0, 67e12, "fp32")
    assert by == "operations" and abs(t - 1.0) < 1e-12


def test_lm_token_flops_by_hand():
    # D 8, one layer, V 10, one key: 2 (4 D^2 + 3 D 4 D) + 4 D + 2 D V
    assert counts.lm_token_flops(8, 1, 10, 1) == 2 * (256 + 768) + 32 + 160


def test_lm_token_flops_match_the_counter():
    lm = unise.LM(dict(hidden_size=8, num_layers=1, num_heads=2,
                       global_size=3, semantic_size=4, rope_theta=1e4), 8)
    x = torch.zeros(4, 8)
    got = counts.count_flops(torch, [lm], lambda: lm.logits(x))
    # the reference scores all 4 x 4 query-key pairs (masking after): 4 D
    # a pair; the count per token is the weights' 2 per parameter
    assert got == 4 * counts.lm_token_flops(8, 1, lm.vocab, 0) + 4 * 8 * 16


def test_lstm_counted_once():
    m = torch.nn.LSTM(3, 4, num_layers=2, bidirectional=True,
                      batch_first=True)
    x = torch.zeros(2, 5, 3)
    want = 10 * 2 * 8 * 4 * (3 + 4) + 10 * 2 * 8 * 4 * (8 + 4)
    assert counts.lstm_flops(m, x) == want
    assert counts.count_flops(torch, [m], lambda: m(x)) == want

"""``flops.py`` on shapes worked out by hand."""

import pytest

from benchmark import flops
from benchmark.flops import Widths

# d 8, 2 layers, 2 query heads and 1 kv head of 4, d_ff 16, vocab 10
DENSE = Widths(d_model=8, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=4,
               d_ff=16, vocab=10)
MOE = Widths(d_model=8, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=4,
             d_ff=16, vocab=10, n_experts=4, experts_per_token=2)


def test_active_params():
    # q 8x8 + k 8x4 + v 8x4 + o 8x8 = 192; gate, up, down 3 x 8 x 16 = 384
    assert flops.layer_params_active(DENSE) == 192 + 384
    # two experts of 384 and a router of 8 x 4
    assert flops.layer_params_active(MOE) == 192 + 2 * 384 + 32


def test_row_flops():
    # 2 x 2 layers x 576 = 2304; attention 4 x 2 layers x 2 heads x 4 x 3
    # keys = 192; head 2 x 8 x 10 = 160
    assert flops.row_flops(DENSE, 3, head=True) == 2304 + 192 + 160
    assert flops.row_flops(DENSE, 1, head=False) == 2304 + 64


def test_chunk_flops_counts_useful_rows_only():
    # one slot: a 2-token prompt piece that samples, wanting 2 tokens, in
    # a 3-step chunk: rows at 1 and 2 keys (the second with the head), one
    # continuation step at 3 keys; the second continuation step and the
    # idle slot count nothing
    pack = {"page": 2, "n_steps": 3, "starts": [0, 0],
            "n_valid": [2, 0], "emit": [True, False], "remaining": [2, 0]}
    assert flops.chunk_flops(DENSE, pack) == 2368 + 2592 + 2656


def test_ragged_launch():
    # slots of 3 rows from 0 and 1 row from 5 and an idle one, pages of
    # 2: q 4 rows x 2 x 4 x 2 B = 64 and out the same 4 rows = 64 (no
    # padded row); K and V of 3 + 6 positions x 1 head x 4 x 2 B, twice
    # = 144; 2 + 3 pages x 4 B = 20; two per-slot scalars x 2 slots with
    # rows x 4 B = 16
    pack = {"page": 2, "starts": [0, 5, 0], "n_valid": [3, 1, 0]}
    n_bytes, n_flops = flops.ragged_launch(DENSE, pack)
    assert n_bytes == 64 + 64 + 144 + 20 + 16
    # causal pairs 0+1+2+3 = 6 and 5+1 = 6 keys; 4 x hd 4 x 2 heads each
    assert n_flops == 4 * 4 * 2 * 12


def test_paged_launch():
    # one live slot at 4 keys, one idle, pages of 2: q and out of the live
    # slot 2 x 2 x 4 x 2 B = 32; K and V 2 x 4 x 1 x 4 x 2 B = 64; 2 pages
    # and 1 length x 4 B = 12
    n_bytes, n_flops = flops.paged_launch(DENSE, [4, 0], 2)
    assert n_bytes == 32 + 64 + 12
    assert n_flops == 4 * 4 * 2 * 4


def test_bounds():
    assert flops.bound_s(3.35e12, 1) == pytest.approx(1.0)
    assert flops.bound_s(1, 989e12) == pytest.approx(1.0)
    pack = {"page": 2, "n_steps": 3, "starts": [4],
            "n_valid": [1], "emit": [True], "remaining": [3]}
    # continuation steps 1 and 2 attend 6 and 7 keys, one launch a layer
    want = 2 * (flops.bound_s(*flops.paged_launch(DENSE, [6], 2))
                + flops.bound_s(*flops.paged_launch(DENSE, [7], 2)))
    assert flops.chunk_paged_bound_s(DENSE, pack) == pytest.approx(want)
    assert flops.chunk_ragged_bound_s(DENSE, pack) == pytest.approx(
        2 * flops.bound_s(*flops.ragged_launch(DENSE, pack)))


def test_widths_from_published_config():
    hf = {"hidden_size": 4096, "num_hidden_layers": 16,
          "num_attention_heads": 32, "num_key_value_heads": 8,
          "intermediate_size": 14336, "vocab_size": 32000,
          "num_local_experts": 8, "num_experts_per_tok": 2}
    w = Widths.from_hf(hf)
    assert (w.head_dim, w.n_experts, w.experts_per_token) == (128, 8, 2)
    # q and o 4096 x 4096, k and v 4096 x 1024; two experts' three
    # 4096 x 14336 matrices; the router: 394 M a layer, so 32 layers and
    # the embedding and head give the published 12.9 B active a token
    assert flops.layer_params_active(w) == 4096 * 10240 + 2 * 3 * 4096 \
        * 14336 + 4096 * 8

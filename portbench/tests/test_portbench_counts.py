"""The yardstick's counts against hand counts at the cells' shapes."""

import pytest

from portbench import counts, harness

FL = counts.Mamba2.from_config(harness.load_json(
    harness.HERE / "configs" / "mamba2-780m-fl8.json"))
SERVE = counts.Mamba2.from_config(harness.load_json(
    harness.HERE / "configs" / "mamba2-780m-serve.json"))


def test_params_match_the_port_and_the_published_size():
    # 8 layers: embedding 50 280 x 1 536, 14 644 112 a layer (its 1 536 pre-norm
    # included), the final norm
    assert FL.layer_params() == 14_644_112
    assert FL.params() == 50_280 * 1_536 + 8 * 14_644_112 + 1_536 == 194_384_512
    assert counts.padded(FL.params(), 1024) == 194_384_896
    assert SERVE.params() == 780_148_992        # mamba2-780m


def test_exchange_bytes_at_the_slot_cell():
    rows, n, block = 8, 194_384_896, 1024
    nb = n // block
    assert counts.quantize_bytes(rows, n, block) == rows * n * 5 + rows * nb * 4
    assert counts.quantize_bytes(rows, n, block) / 1e9 == pytest.approx(7.78, abs=0.005)
    assert counts.dequant_accumulate_bytes(rows, n, block) / 1e9 == pytest.approx(14.0, abs=0.01)
    assert counts.mix_least_bytes(rows, n) / 1e9 == pytest.approx(12.44, abs=0.005)
    assert counts.seconds_at_hbm(counts.mix_least_bytes(rows, n)) * 1e3 == pytest.approx(
        3.714, abs=0.001)


def test_flops_per_token():
    D, di, H, N, P, Q, V = 1536, 3072, 48, 128, 64, 256, 50280
    matmul = 2 * D * di + 2 * D * N + D * H + di * D
    assert FL.layer_matmul_params() == matmul == 14_622_720
    ssd = N * (Q + 1) + H * P * (Q + 1) + H * 4 * N * P
    assert FL.ssd_chunked_flops() == pytest.approx(ssd)
    layer = 2 * matmul + 2 * 4 * (di + 2 * N) + ssd
    assert FL.train_flops_per_token() == pytest.approx(3 * (8 * layer + 2 * D * V))
    # a round: 8 satellites x 2 steps x 4 x 256 tokens, ~20 TFLOP
    round_flops = 8 * 2 * 4 * 256 * FL.train_flops_per_token()
    assert round_flops / 1e12 == pytest.approx(20.04, abs=0.01)
    # a generated token at 48 layers: ~1.6 GFLOP
    decode = 48 * (2 * matmul + 2 * 4 * (di + 2 * N) + H * 4 * N * P) + 2 * D * V
    assert SERVE.generated_flops(from_decode=True) == pytest.approx(decode)
    assert SERVE.generated_flops(from_decode=False) == 2 * D * V
    assert SERVE.prompt_flops_per_token() == pytest.approx(48 * layer)

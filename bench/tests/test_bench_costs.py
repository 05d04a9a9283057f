"""The frozen operation and byte counts against hand counts at the cells'
shapes."""
import pytest

from bench.costs import flash, matmul, model_flops, peaks
from bench.harness import spec
from bench.tests.conftest import CELLS


def model(i):
    return spec.load_cell(CELLS[i]).config["model"]


def test_gpt2_1p5b_counts():
    m = model(0)
    d, f, L, v = 1600, 6400, 48, 50304
    # the tied table once, as the head; no positions, norms or biases
    n = v * d + L * (4 * d * d + 2 * d * f)
    assert model_flops.matmul_param_count(m) == n == 1_555_046_400
    assert model_flops.active_param_count(m) == n
    attn = 48 * 4 * 8 * 1024 * 1024 / 2 * 25 * 64
    assert model_flops.train_step_flops(m, 8, 1024) == pytest.approx(
        6 * n * 8192 + 3 * attn, rel=1e-12)


def test_deepseek_stage_counts():
    m = model(1)
    d, f, e, L, v = 2048, 1408, 64, 4, 102400
    experts = 3 * e * d * f
    per_layer = 4 * d * 16 * 128 + d * e + experts + 3 * d * 2 * f
    # the head, not the untied input table (a gather) or the norms
    n = v * d + L * per_layer
    assert model_flops.matmul_param_count(m) == n
    active = n - L * experts + L * experts * 6 // 64
    assert model_flops.active_param_count(m) == active
    attn = 4 * 4 * 8 * 1024 * 1024 / 2 * 16 * 128
    assert model_flops.train_step_flops(m, 8, 1024) == pytest.approx(
        6 * active * 8192 + 3 * attn, rel=1e-12)


@pytest.mark.parametrize("bh,s,d", [(8 * 25, 1024, 64), (8 * 16, 1024, 128),
                                    (8 * 25, 72, 64)])
def test_flash_counts(bh, s, d):
    pairs = s * (s + 1) // 2
    t = bh * s * d * 4
    assert flash.cost("fwd", bh, s, d) == (4 * bh * pairs * d,
                                           4 * t + bh * s * 4)
    assert flash.cost("preprocess", bh, s, d) == (2 * bh * s * d,
                                                  2 * t + bh * s * 4)
    assert flash.cost("dq", bh, s, d) == (6 * bh * pairs * d,
                                          5 * t + 2 * bh * s * 4)
    assert flash.cost("dkv", bh, s, d) == (8 * bh * pairs * d,
                                           6 * t + 2 * bh * s * 4)
    # one TF32 product: gpt2-1.5b's forward at 8 x 1024 is bound by its
    # 210.5 MB (0.0628 ms), not its 2.69e10 FLOPs (0.0543 ms)
    fl, by = flash.cost("fwd", 200, 1024, 64)
    assert peaks.bound_s(fl, by) == by / 3.35e12 == pytest.approx(6.285e-5,
                                                                 rel=1e-3)


def test_flash_kernel_names():
    assert flash.kind_of("void flash_fwd_kernel<float, 64>(float const*)") \
        == "fwd"
    assert flash.kind_of("void bwd_dkv_kernel<float, 128>(...)") == "dkv"
    assert flash.kind_of("void bwd_dq_kernel<float, 64>(...)") == "dq"
    assert flash.kind_of("void bwd_preprocess_kernel<float>(...)") == \
        "preprocess"
    assert flash.kind_of("ampere_sgemm_128x64_nn") == ""


def test_matmul_counts():
    # an attention projection of gpt2-1.5b at 8 x 1024, a bias product, and
    # deepseek's expert product at capacity 120 a row
    assert matmul.cost("aten::mm", [[8192, 1600], [1600, 1600]],
                       ["float", "float"]) == (
        2 * 8192 * 1600 * 1600, 4 * (8192 * 1600 * 2 + 1600 * 1600))
    fl, by = matmul.cost("aten::addmm", [[6400], [8192, 1600], [1600, 6400],
                                         [], []], ["float"] * 3)
    assert fl == 2 * 8192 * 1600 * 6400
    assert by == 4 * (6400 + 8192 * 1600 + 1600 * 6400 + 8192 * 6400)
    assert matmul.cost("aten::bmm", [[64, 960, 2048], [64, 2048, 1408]],
                       ["float"] * 2) == (
        2 * 64 * 960 * 2048 * 1408,
        4 * 64 * (960 * 2048 + 2048 * 1408 + 960 * 1408))
    assert matmul.cost("aten::mm", [[4, 4]], ["float"]) is None

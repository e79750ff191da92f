"""The kernels' work counts: by hand at a small shape, and the bounds of
the port's kernel table at 500k cells (PERF.md: K7 0.061 ms a round, K2
0.0187 ms a round, K9 0.120 ms)."""

import pytest

from benchmark.work import k2, k7, k9, peaks


def test_by_hand():
    # K = 2, d = 3, Np = 8, one covariate, 2 tiles, B = 2
    assert k7.round_work(2, 3, 8, 1, 2, 2) == (4 * (16 + 8 + 16), 0.0)
    assert k7.round_work(2, 3, 8, 1, 2, 2, write_r=True) == (4 * (16 + 8 + 16 + 16), 0.0)
    # the moments of 1 joint batch: Z_orig 24 values read, (1 + 1) * 2 * 4 written
    assert k7.round_work(2, 3, 8, 1, 2, 2, write_r=True, n_joint=1) == (
        4 * (56 + 24 + 16), 2.0 * 2 * 4 * 8)
    # a phase of 2 rounds over N = 10: Z 30, codes 10, block ids 10, two int64 permutations
    assert k2.phase_work(2, 3, 10, 1, 2) == (4 * 50 + 8 * 20, 2.0 * 2 * 3 * 10)
    # 6 cells: R 12, Z_orig 18 read, Z_corr 18 written, 2 joint tables of 3 x 2
    assert k9.call_work(2, 3, 6, 1) == (4 * (12 + 36 + 12), 2.0 * 2 * 3 * 6)
    assert peaks.bound_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_seconds(0.0, 67e12) == pytest.approx(1.0)


def test_the_table_bounds_at_500k():
    K, d, N, Np, NT, B = 100, 50, 500_000, 503_808, 123, 10
    ms = lambda w: 1e3 * peaks.bound_seconds(*w)
    assert ms(k7.round_work(K, d, Np, 1, NT, B)) == pytest.approx(0.061, abs=5e-4)
    nbytes, flops = k2.phase_work(K, d, N, 1, 4)
    assert ms((nbytes / 4, flops / 4)) == pytest.approx(0.0187, abs=5e-5)
    assert ms(k9.call_work(K, d, Np, 10)) == pytest.approx(0.120, abs=5e-4)

"""The frozen peaks and the byte and operation counts of the stages."""
import pytest

from qem_bench import yardstick as y


def test_peaks():
    assert y.HBM_BYTES_PER_S == 3.35e12 and y.F32_FLOPS_PER_S == 67e12


def test_step_flops():
    assert y.step_flops(10, 9, 1024) == 53311
    assert y.step_flops(21, 20, 2 ** 21) == 201326721


def test_kicked_evolve_work_at_the_labels_batch():
    n_bytes, n_flops = y.kicked_evolve_work(524288, 10, 9, 4)
    assert n_bytes == 4 * 524288 * 77 + 4 * 524288 * 1024
    assert n_flops == 524288 * (4 * 53311 + 3 * 1024)
    assert y.bound(n_bytes, n_flops) == pytest.approx(1.6926e-3, rel=1e-4)


def test_window_evolve_work_at_a_chunk():
    n_bytes, n_flops = y.window_evolve_work(128, 21, 20, 10)
    assert n_bytes == 10 * 16 * 128 * 2 ** 21 + 4 * 128 * 411
    assert n_flops == 128 * 10 * (201326721 + 5 * 2 ** 21)
    # a chunk's least time is the state's ten round trips: ~12.8 ms
    assert y.bound(n_bytes, n_flops) == pytest.approx(12.82e-3, rel=1e-3)


def test_bound_takes_the_larger():
    assert y.bound(3.35e12, 0) == 1.0
    assert y.bound(0, 67e12) == 1.0

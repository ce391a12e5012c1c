"""The byte counts against counts made by hand."""
from core import yardstick as y


def test_net_stats_walk_bytes_by_hand():
    # one member, 2 cells, f32: reads T, dtau (2 each), up_sw, down_sw,
    # prev (3 each), top (1) = 14 floats; writes net (3) + 4 stats = 7
    assert y.net_stats_walk_bytes(1, 2) == (14 + 7) * 4
    assert y.net_stats_walk_bytes(65536, 59) == 65536 * (
        (2 * 59 + 3 * 60 + 1) + (60 + 4)) * 4


def test_iso_fit_bytes_by_hand():
    # theta in and the fit out [3, 5], weights [5]
    assert y.iso_fit_bytes(3, 5) == (15 + 15 + 5) * 4


def test_step_bytes_by_hand():
    # n = 1: floats T 1, net 2, t, ft, delta, 5 controller = 11;
    # ints 4 (index, two counters, step); bools 2 masks + 4 flags = 6
    state = 11 * 4 + 4 * 4 + 6
    forcing = (1 + 2 * 2 + 1) * 4
    assert y.step_bytes(1, 1) == 2 * state + forcing + 2 * 4
    assert y.step_bytes(1, 1, convective=True) == 2 * state + forcing + 3 * 4


def test_roofline_percent():
    assert y.roofline_percent(y.HBM_BYTES_PER_S, 1.0) == 100.0
    assert y.roofline_percent(1, 0) is None


def test_frozen_bench_arithmetic():
    assert y.days([86400.0, 43200.0]) == 1.5
    f = y.flags([True, False], [False, True], [False, False], [False, False])
    assert f == dict(converged_fraction=0.5, equilibrium=False,
                     timed_out=True, failed=False, nan=False)

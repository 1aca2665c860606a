"""The frozen roofline arithmetic against hand-worked counts."""

import pytest

from bench_h100 import roofline


@pytest.mark.parametrize("kind,dim,mode,ops", [
    # d^2: 3D ops; w: 3 (float32) or 9 (the int chain); t-form: 3D.
    ("sym_t", 2, "float32", 6 + 3 + 6),
    ("sym_t", 2, "int4", 6 + 9 + 6),
    ("sym_t", 3, "float32", 9 + 3 + 9),
    ("sym_t", 3, "int4", 9 + 9 + 9),
    # general masses: 2 G m multiplies and 4D fused multiply-adds.
    ("sym_gm", 2, "float32", 6 + 3 + 2 + 8),
    ("sym_gm", 3, "int4", 9 + 9 + 2 + 12),
    ("sym_t_max", 2, "int4", 6 + 9 + 6 + 1),
    ("pe", 3, "float32", 9 + 4),
])
def test_pair_ops_hand_counts(kind, dim, mode, ops):
    assert roofline.pair_ops(kind, dim, mode) == ops


@pytest.mark.parametrize("n,dim,mode,ms", [
    # N(N-1)/2 pairs x ops / 67 TFLOP/s, as the port's table records them.
    (131072, 2, "float32", 8589869056 * 15 / 67e12 * 1e3),
    (131072, 2, "int4", 8589869056 * 21 / 67e12 * 1e3),
    (1048576, 3, "float32", 549755289600 * 21 / 67e12 * 1e3),
])
def test_force_bound_by_operations(n, dim, mode, ms):
    got, by = roofline.force_bound_ms(n, dim, mode, equal_masses=True)
    assert by == "operations"
    assert got == pytest.approx(ms, rel=1e-12)


def test_force_bound_values_in_the_port_table():
    # 1.9231 / 2.6923 ms at 131072 D=2 and 172.3 ms at 1M D=3 (PERF.md).
    assert round(roofline.force_bound_ms(131072, 2, "float32", True)[0],
                 4) == 1.9231
    assert round(roofline.force_bound_ms(131072, 2, "int4", True)[0],
                 4) == 2.6923
    assert round(roofline.force_bound_ms(1048576, 3, "float32", True)[0],
                 1) == 172.3


def test_bound_by_bytes_where_ops_are_few():
    ms, by = roofline.bound(pairs=1.0, ops_per_pair=1, nbytes=3.35e12)
    assert by == "bytes" and ms == pytest.approx(1000.0)

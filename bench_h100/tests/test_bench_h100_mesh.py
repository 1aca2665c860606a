"""The four-card cell ``disk2d-131k-mesh4-int4`` (entry ``mesh_history``):
on the CPU on a virtual mesh of 4 (the ring's plain tiles) at a small N, a
sound run is correct and each planted fault of the ring comes out not
correct; the roles files put the ring's kernels and peer copies into
roles; on four cards, the ring's force at the cell's ICs is within the
cell's limit of the reference."""

import pytest
import torch

from bench_h100 import devtrace, harness, ics, reference
from nbody_tpu_torch.parallel import ring

CELL = "disk2d-131k-mesh4-int4"
N = 1024
SMALL = {"n": N, "snapshot_interval": 3}
SEED = 2 ** 31 + 101


def run(seed=SEED):
    """(the result line, its Run) of a short run on the CPU."""
    line = harness.run_cell(CELL, seed, 0, False, "cpu",
                            traffic_overrides=SMALL)
    return line, line.pop("_run")


def test_a_sound_run_on_a_virtual_mesh_of_the_cells_cards_is_correct():
    line, run_ = run()
    assert run_.workload["chips"] == 4
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert run_.work["moved_bytes_peer"] == 0


def test_a_ring_without_graph_ticks_fails_the_cell_before_any_work(
        monkeypatch):
    """The configuration's ticks are CUDA graphs: a program whose ring has
    none (``ring.graph_ticks`` absent) fails at set-up, before the ICs."""
    monkeypatch.delattr(ring, "graph_ticks")
    monkeypatch.setattr(ics, "make", lambda *a: pytest.fail("ICs made"))
    with pytest.raises(RuntimeError, match="CUDA graphs"):
        run()


def _stale_rotation(rotate):
    """Shard 1 keeps the block it held: a rotation that hands it a stale
    block."""
    def stale(blocks, k, mesh, ragged=False):
        out = rotate(blocks, k, mesh, ragged)
        out[1] = blocks[1]
        return out
    return stale


def _reduce_without_shard_3(reduce):
    """Every max reduce folds shards 0-2 only."""
    def partial(values, op, mesh):
        if op is torch.maximum:
            values = list(values[:3]) + [values[0]]
        return reduce(values, op, mesh)
    return partial


def _reactions_stay(rotate):
    """The reactions' trip home (the one rotation by -S//2) delivers
    zeros."""
    def lost(blocks, k, mesh, ragged=False):
        out = rotate(blocks, k, mesh, ragged)
        return [torch.zeros_like(x) for x in out] if k < 0 else out
    return lost


def _farthest_pair_only_shard_3_visits() -> int:
    """The first seed whose order puts the ICs' farthest pair in block
    pairs {3, 3} or {2, 3}, which only shard 3's max pass visits: where
    another shard also sees it, leaving shard 3 out changes nothing."""
    cfg = harness.Manifest().config("disk2d-mesh4")
    for seed in range(1, 65):
        pos, _, _ = ics.make(cfg, N, seed, "cpu")
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        a, b = divmod(int(d2.argmax()), N)
        if sorted((a // (N // 4), b // (N // 4))) in ([3, 3], [2, 3]):
            return seed
    raise AssertionError("no seed in 1-64 puts the farthest pair there")


FAULTS = {
    "stale_rotation": ("_rotate", _stale_rotation),
    "reduce_without_shard_3": ("_reduce", _reduce_without_shard_3),
    "reactions_stay": ("_rotate", _reactions_stay),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_ring_fault_is_not_correct(fault, monkeypatch):
    seed = (_farthest_pair_only_shard_3_visits()
            if fault == "reduce_without_shard_3" else SEED)
    name, plant = FAULTS[fault]
    monkeypatch.setattr(ring, name, plant(getattr(ring, name)))
    line, _ = run(seed)
    assert not line["correct"], (fault, line["checks"])


def test_kernel_roles_name_the_ring_kernels_and_peer_copies():
    roles = devtrace.load_roles()
    assert devtrace.role_of("pair_max_tiled", roles) == "bounds"
    assert devtrace.role_of("pair_max_tiles", roles) == "bounds"
    assert devtrace.role_of("Memcpy PtoP", roles) == "ring_copy"
    # The roles of the single-card cells' kernels, as before.
    assert devtrace.role_of("sym_one_pass<3, 2, false, false>",
                            roles) == "force"
    assert devtrace.role_of("pair_one_pass<0, 3, false>", roles) == "force"
    assert devtrace.role_of("max_d2_tiled", roles) == "bounds"
    assert devtrace.role_of("pair_pe_tiled<2>", roles) == "snapshot"
    assert devtrace.role_of("at::native::elementwise_kernel<128, 2>",
                            roles) == "other"
    for name in ("Memcpy DtoH", "Memcpy HtoD", "Memcpy DtoD", "Memset",
                 "max_d2_single", "sym_one_pass_reduce<2>"):
        assert devtrace.role_of(name, roles) != "ring_copy"


@pytest.mark.gpu
def test_the_ring_force_on_four_cards_is_within_the_cells_limit():
    """The sym ring's int4 accelerations at the cell's ICs (131072 stars,
    one shard a card) against the reference's, in grid steps."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 NVIDIA GPUs")
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.ops.precision import Quantizer
    man = harness.Manifest()
    c = man.config("disk2d-mesh4")
    limit = man.limits(CELL)["force_flips"]
    pos, _, m = ics.make(c, 131072, SEED, "cuda")
    acc = ring.ring_accelerations(
        pos, m, Quantizer.from_string("int4"),
        SimConfig(G=c["G"], softening=c["softening"], dt=c["dt"]),
        ring.make_particle_mesh(4, "cuda"), quantize_forces=True,
        schedule="sym", uniform_gm=True)
    eps2 = c["softening"] ** 2
    levels = reference.LEVELS["int4"]
    lo, hi = reference.log_grid(pos, eps2, c["min_dist_sq"])
    raw, _ = reference.accelerations(
        pos, c["G"] * m.to(torch.float64), torch.arange(131072,
                                                        device=pos.device),
        eps2, grid=(levels, c["min_dist_sq"], lo, hi))
    ref, step = reference.quantize_force(raw, levels)
    flips = float(torch.round((acc.to(torch.float64) - ref).abs()
                              / step).sum())
    assert flips <= limit, flips

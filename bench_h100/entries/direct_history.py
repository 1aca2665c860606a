"""Entry ``direct_history``: ``DirectSimulation.run_with_history`` of the
port, one unit of work a snapshot chunk (``snapshot_interval`` ticks and
their on-device snapshot, copied to the host at the chunk's end).

Every unit integrates the ICs from tick 0: the simulation's state is set
back to the one set-up built before each chunk, so every unit of every
run does the same work, the first ``snapshot_interval`` ticks of an
integration. A run that went on would drift into a state the seed picks
by chaos (the seed's order of the same stars changes every sum's
rounding): an int4 disk's escapers make the pruned bounds pass fall back
to the full pass over hundreds of ticks in some seeds' runs and in none
of others', a change of the rate of up to ~7% that two runs of one seed
do not show. So the cells see the bounds pass only as its candidates
run it.

Set-up makes the ICs from the seed on the card, builds the simulation
(which evaluates the force at the ICs) and runs one tick with its snapshot
through the window's own call, which builds and warms every kernel the
window launches. That first tick is also the check's first step.

After the window the last unit is run again through the same call from
the same start, as its first ``snapshot_interval - 1`` ticks and then its
last tick, each a chunk: the replay has to end bitwise where the window
ended, and its state before the last tick gives the check the window's
last tick.

The check (``check``) follows the program step by step from its own
state, as far as the plain reference can afford at these sizes:
  * force: the program's accelerations at the ICs, after the first tick,
    before the window's last tick and at the window's end, against the
    reference's force of the same positions (sampled receivers in float
    modes; in int modes every receiver, as the force grid spans every
    component);
  * step: the first tick and the window's last tick, each against one
    kick-drift-kick step of the reference from the state before it, with
    the program's two force evaluations (judged above);
  * replay: state elements in which the replay's end differs from the
    window's end (an exact comparison);
  * energies: the window's last snapshot against the reference's kinetic
    and potential energy of the final state.
The ticks between are judged through the states they lead to: following
each would take the reference as many O(N^2) evaluations as the window.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from bench_h100 import ics, reference


def program_factory(run):
    """The system under test: the port's DirectSimulation as a user calls
    it, through the force routing "auto", exact bounds every tick."""
    from nbody_tpu_torch.config import SimConfig
    from nbody_tpu_torch.models.direct import DirectSimulation
    c = run.config
    cfg = SimConfig(G=c["G"], softening=c["softening"], dt=c["dt"])

    def make(pos, vel, m):
        return DirectSimulation(pos, vel, m, precision=run.traffic["mode"],
                                cfg=cfg, force_impl=run.traffic["force_impl"],
                                device=run.device)
    return make


class State:
    pass


def _launches() -> dict:
    from nbody_tpu_torch.ops import hopper_nbody as hn
    return dict(hn.LAUNCHES)


def prepare(run, program=None) -> State:
    st = State()
    make = program or program_factory(run)
    run.mark("program imported")
    st.ics = ics.make(run.config, run.traffic["n"], run.seed, run.device)
    run.mark("ICs made")
    st.sim = make(*st.ics)
    st.s0 = st.sim.state
    run.mark("simulation built")
    snaps, _ = st.sim.run_with_history(1, 1)
    st.s1 = st.sim.state
    run.mark("first tick")
    st.snaps = snaps
    st.interval = run.traffic["snapshot_interval"]
    st.launches0 = _launches() if program is None else None
    return st


def unit(run, st) -> dict:
    k = st.interval
    st.sim.state = st.s0
    st.snaps, _ = st.sim.run_with_history(k, k)
    ke, pe = float(st.snaps.kinetic[-1]), float(st.snaps.potential[-1])
    n = run.traffic["n"]
    return {"attempted": 1,
            "failed": int(not (math.isfinite(ke) and math.isfinite(pe))),
            "ticks": k, "snapshots": 1, "pairs": n * n * k}


def counters(run, st) -> dict:
    """The program's kernel launches over the window."""
    if st.launches0 is None:
        return {}
    launches = _launches()
    return {"launches": {k: launches[k] - st.launches0.get(k, 0)
                         for k in launches}}


def _replay(st):
    """The last unit again from its start, as its first k - 1 ticks and
    its last tick: (the state before the last tick, the replay's end)."""
    k = st.interval
    st.sim.state = st.s0
    if k > 1:
        st.sim.run_with_history(k - 1, k - 1)
    before = st.sim.state
    st.sim.run_with_history(1, 1)
    return before, st.sim.state


def _differing(a, b) -> int:
    """State elements (positions, velocities, accelerations) in which two
    states differ bitwise."""
    return sum(int((x != y).sum()) for x, y in (
        (a.positions, b.positions), (a.velocities, b.velocities),
        (a.accelerations, b.accelerations)))


def finish(run, st) -> dict:
    """What the check reads; the simulation itself is dropped."""
    fin = st.sim.state
    out = {"ics": st.ics, "acc0": st.s0.accelerations,
           "keT": float(st.snaps.kinetic[-1]),
           "peT": float(st.snaps.potential[-1])}
    t = time.perf_counter()
    before, again = _replay(st)
    print(f"replay: {time.perf_counter() - t:.1f} s", file=sys.stderr)
    for tag, s in (("1", st.s1), ("P", before), ("T", fin)):
        out["pos" + tag], out["vel" + tag], out["acc" + tag] = (
            s.positions, s.velocities, s.accelerations)
    out["replay_diff"] = _differing(fin, again)
    st.sim = st.s0 = st.s1 = None
    return out


def sample_rows(n: int, count: int, seed: int, device) -> torch.Tensor:
    """``count`` receivers drawn from the seed (every one if count >= n)."""
    if count >= n:
        return torch.arange(n, device=device)
    gen = torch.Generator().manual_seed(int(seed) % (2 ** 63) ^ 0x5EED)
    return torch.randperm(n, generator=gen)[:count].sort().values.to(device)


def _force_number(run, out) -> tuple:
    """("force_err", the widest gap over the four evaluations, each
    component's gap over its sum of absolute terms) in float modes;
    ("force_flips", grid steps by which the program's components differ
    from the reference's, summed over the four) in int modes."""
    c, t = run.config, run.traffic
    pos0, _, m = out["ics"]
    eps2 = c["softening"] ** 2
    gm = c["G"] * m.to(torch.float64)
    n = pos0.shape[0]
    levels = reference.LEVELS.get(t["mode"])
    pairs = ((pos0, out["acc0"]), (out["pos1"], out["acc1"]),
             (out["posP"], out["accP"]), (out["posT"], out["accT"]))
    if levels is None:
        rows = sample_rows(n, t["check_rows"], run.seed, pos0.device)
        worst = 0.0
        for pos, acc in pairs:
            ref, scale = reference.accelerations(pos, gm, rows, eps2,
                                                 want_scale=True)
            gap = (acc.index_select(0, rows).to(torch.float64) - ref).abs()
            worst = max(worst, float((gap / scale).max()))
        return "force_err", worst
    flips = 0.0
    rows = torch.arange(n, device=pos0.device)
    for pos, acc in pairs:
        lo, hi = reference.log_grid(pos, eps2, c["min_dist_sq"])
        raw, _ = reference.accelerations(
            pos, gm, rows, eps2, grid=(levels, c["min_dist_sq"], lo, hi))
        ref, step = reference.quantize_force(raw, levels)
        gap = (acc.to(torch.float64) - ref).abs()
        flips += float(torch.round(gap / step).sum())
    return "force_flips", flips


def _step_number(run, out) -> float:
    """The first tick and the window's last tick, each against one
    reference step from the state before it: the widest gap of a position
    (velocity) component over the median particle's displacement (change
    of velocity) in that tick."""
    pos0, vel0, _ = out["ics"]
    worst = 0.0
    ticks = ((pos0, vel0, out["acc0"], "1"),
             (out["posP"], out["velP"], out["accP"], "T"))
    for pos, vel, acc, end in ticks:
        p_ref, v_ref = reference.kdk(pos, vel, acc, out["acc" + end],
                                     run.config["dt"])
        for got, want, start in ((out["pos" + end], p_ref, pos),
                                 (out["vel" + end], v_ref, vel)):
            moved = (want - start.to(torch.float64)).norm(dim=1).median()
            gap = (got.to(torch.float64) - want).abs().max()
            worst = max(worst, float(gap / moved))
    return worst


def check(run, out) -> list:
    """[(name, value, limit, ok)]: each number against its limit."""
    c = run.config
    _, _, m = out["ics"]
    t = time.perf_counter()
    force_name, force = _force_number(run, out)
    t_force = time.perf_counter() - t
    ke = reference.kinetic(out["velT"], m)
    pe = reference.potential(out["posT"], m, c["G"], c["softening"] ** 2)
    print(f"reference: force {t_force:.1f} s, energies "
          f"{time.perf_counter() - t - t_force:.1f} s", file=sys.stderr)
    numbers = [(force_name, force), ("step_err", _step_number(run, out)),
               ("replay_diff", out["replay_diff"]),
               ("ke_err", abs(out["keT"] - ke) / abs(ke)),
               ("pe_err", abs(out["peT"] - pe) / abs(pe))]
    return [(name, value, run.limits[name],
             math.isfinite(value) and value <= run.limits[name])
            for name, value in numbers]

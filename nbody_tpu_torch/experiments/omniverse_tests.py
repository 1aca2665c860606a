"""Omniverse tests: four structural probes of the simulation substrate.

PyTorch counterpart of ``nbody_tpu.experiments.omniverse_tests``
(reference: omniverse_tests.py:67-1036):

1. **RecursivePhysicsMirror** — nested concentric shells, recursion depth
   pushed upward; find the depth where physics jitters, NaNs, or
   wall-time explodes (reference: :67-218).
2. **FluidDynamicsChaos** — a large particle cloud around a point mass;
   detect particle "merging" (level-of-detail cheating) and
   event-horizon deletion (reference: :240-407). At the default 20000
   particles plus the central mass the ticks run the sym_force kernel's
   general body (unequal masses).
3. **NeuralHardwareBridge** — an LSTM glitch predictor trained on
   synthetic RSI sequences with planted glitch patterns; accuracy /
   precision / recall / F1 verdict (reference: :414-632). The LSTM is
   written as plain tensor ops in the JAX package's gate order and
   parameter layout (``Wx`` (in, 4H), ``Wh`` (H, 4H), gates i, f, g, o),
   trained by full-batch SGD with ``torch.autograd``; ``nn.LSTM`` is not
   used, since its gate layout differs and the parameters could not be
   carried across.
4. **VoxelSpaceTimeGrid** — per-voxel mini-simulations over a spatial
   grid, mapping RSI spatially; anisotropy gradient (reference: :653-819).

Every probe runs on ``--device`` (default ``cuda``; with no card it raises
and names ``--device cpu``).

Usage:
    python -m nbody_tpu_torch.experiments.omniverse_tests --quick
    python -m nbody_tpu_torch.experiments.omniverse_tests --device cpu --quick
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.experiments._common import to_host
from nbody_tpu_torch.models.direct import DirectSimulation, _resolve_device
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.ops.precision import Precision
from nbody_tpu_torch.utils.reproducibility import seed_key


# --------------------------------------------------------------------------
# 1. Recursive physics mirror
# --------------------------------------------------------------------------

MIRROR_SHELL = 64   # particles a shell
MIRROR_TICKS = 50


def recursive_physics_mirror(max_depth: int = 60, seed: int = 42,
                             device=None) -> dict:
    """(reference: omniverse_tests.py:67-218): shells at radius 10/2^k.
    Beyond f32 resolution the innermost shells collapse — find the depth."""
    device = _resolve_device(device)
    print("\n--- OMNIVERSE 1: RECURSIVE PHYSICS MIRROR ---")
    results = []
    breakdown_depth = None
    for depth in range(0, max_depth, 5):
        radius = 10.0 / (2.0 ** depth)
        if radius < 1e-38:
            breakdown_depth = depth
            results.append({"depth": depth, "radius": radius,
                            "status": "UNDERFLOW"})
            print(f"  depth {depth}: radius underflows f32")
            break
        n = MIRROR_SHELL
        angles = torch.arange(n, dtype=torch.float32) * (2 * math.pi / n)
        pos = radius * torch.stack([torch.cos(angles), torch.sin(angles)],
                                   dim=1)
        v_circ = math.sqrt(max(0.001 * n / max(radius, 1e-30), 0.0)) * 0.1
        vel = v_circ * torch.stack([-torch.sin(angles), torch.cos(angles)],
                                   dim=1)
        cfg = SimConfig(softening=radius * 0.01 if radius > 1e-30 else 1e-30,
                        dt=min(0.01, radius * 0.01))
        t0 = time.perf_counter()
        sim = DirectSimulation(pos, vel, torch.ones(n),
                               precision=Precision.FLOAT32, cfg=cfg,
                               force_impl="dense", device=device)
        sim.step(MIRROR_TICKS)
        p = to_host(sim.positions)
        wall = time.perf_counter() - t0
        nan = bool(np.isnan(p).any())
        collapsed = bool(np.sqrt((p ** 2).sum(1)).max() < radius * 1e-3)
        status = "NaN" if nan else ("COLLAPSED" if collapsed else "ok")
        results.append({"depth": depth, "radius": radius, "wall_s": wall,
                        "status": status})
        print(f"  depth {depth:3d} (r={radius:.2e}): {status} "
              f"({wall:.1f}s)")
        if nan or collapsed:
            breakdown_depth = depth
            break
    return {"results": results, "breakdown_depth": breakdown_depth}


# --------------------------------------------------------------------------
# 2. Fluid dynamics chaos
# --------------------------------------------------------------------------

CENTRAL_MASS = 1000.0
FLUID_SOFTENING = 0.05


def cloud_positions(generator: torch.Generator, n: int) -> torch.Tensor:
    """The cloud's Gaussian positions, (n, 2) of scale 5."""
    return torch.randn((n, 2), generator=generator,
                       device=generator.device) * 5.0


def fluid_initial_conditions(num_particles: int, seed: int):
    """A heavy particle at the origin and a swirling Gaussian cloud around
    it (reference: omniverse_tests.py:255-270): (positions, velocities,
    masses) of num_particles + 1 bodies."""
    cloud = cloud_positions(seed_key(seed), num_particles)
    pos = torch.cat([torch.zeros((1, 2)), cloud])
    r = torch.linalg.vector_norm(cloud, dim=1, keepdim=True) + 0.1
    tang = torch.stack([-cloud[:, 1], cloud[:, 0]], dim=1) / r
    vel = torch.cat([torch.zeros((1, 2)),
                     tang * torch.sqrt(0.001 * CENTRAL_MASS / r)])
    m = torch.ones(num_particles + 1)
    m[0] = CENTRAL_MASS
    return pos, vel, m


def fluid_dynamics_chaos(num_particles: int = 20000, num_ticks: int = 200,
                         seed: int = 42, device=None) -> dict:
    """(reference: omniverse_tests.py:240-407): cloud around a point mass;
    look for particle merging (many particles at identical positions =
    LOD cheating) and event-horizon deletion (particles vanishing into
    the singularity = non-finite or escaping to infinity)."""
    device = _resolve_device(device)
    print("\n--- OMNIVERSE 2: FLUID DYNAMICS CHAOS ---")
    pos, vel, m = fluid_initial_conditions(num_particles, seed)
    sim = DirectSimulation(pos, vel, m, precision=Precision.FLOAT32,
                           cfg=SimConfig(softening=FLUID_SOFTENING),
                           device=device)
    sim.step(num_ticks)
    p = to_host(sim.positions)

    finite = np.isfinite(p).all(axis=1)
    deleted = int((~finite).sum())
    escaped = int((np.sqrt((p[finite] ** 2).sum(1)) > 1000).sum())
    # merging: count particles sharing a rounded cell with >= 5 others
    cells = np.round(p[finite] / 0.01).astype(np.int64)
    _, counts = np.unique(cells, axis=0, return_counts=True)
    merged = int(counts[counts >= 5].sum())
    lod_cheating = merged > num_particles * 0.01
    print(f"  deleted(non-finite)={deleted}, escaped={escaped}, "
          f"merged-in-cells={merged} "
          f"({'LOD CHEATING' if lod_cheating else 'no merging'})")
    return {"deleted": deleted, "escaped": escaped, "merged": merged,
            "lod_cheating_detected": bool(lod_cheating)}


# --------------------------------------------------------------------------
# 3. Neural hardware bridge (LSTM glitch predictor, plain tensor ops)
# --------------------------------------------------------------------------

LSTM_HIDDEN = 16
LSTM_LR = 0.5


def _lstm_init(generator: torch.Generator, input_dim: int, hidden: int,
               out_dim: int, device=None) -> dict:
    """JAX's parameter layout and scales (omniverse_tests.py:133-142),
    drawn from ``generator``."""
    s = 1.0 / math.sqrt(hidden)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device) * s

    params = {
        "Wx": normal(input_dim, 4 * hidden),
        "Wh": normal(hidden, 4 * hidden),
        "b": torch.zeros(4 * hidden),
        "Wo": normal(hidden, out_dim),
        "bo": torch.zeros(out_dim),
    }
    return {k: v.to(device) for k, v in params.items()}


def _lstm_apply(params: dict, seq: torch.Tensor) -> torch.Tensor:
    """seq: (..., T, input_dim) -> logits (...): the cell of JAX's
    ``_lstm_apply`` (z = x Wx + h Wh + b, split into i, f, g, o) over a
    batch of sequences at once."""
    hidden = params["Wh"].shape[0]
    h = seq.new_zeros((*seq.shape[:-2], hidden))
    c = torch.zeros_like(h)
    for t in range(seq.shape[-2]):
        z = seq[..., t, :] @ params["Wx"] + h @ params["Wh"] + params["b"]
        i, f, g, o = torch.split(z, hidden, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
    return (h @ params["Wo"] + params["bo"])[..., 0]


def _lstm_loss(params: dict, xb: torch.Tensor,
               yb: torch.Tensor) -> torch.Tensor:
    """Mean logistic loss, softplus(logit) - y logit (JAX's loss_fn)."""
    logits = _lstm_apply(params, xb)
    return torch.mean(torch.logaddexp(logits, torch.zeros_like(logits))
                      - yb * logits)


def _sgd_step(params: dict, xb: torch.Tensor, yb: torch.Tensor,
              lr: float) -> dict:
    """One full-batch SGD step, p - lr * dloss/dp (JAX's train_epoch)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(_lstm_loss(leaves, xb, yb),
                                list(leaves.values()))
    with torch.no_grad():
        return {k: p - lr * g
                for (k, p), g in zip(leaves.items(), grads)}


def glitch_sequences(num_sequences: int, seq_len: int, seed: int):
    """Synthetic RSI sequences, half with a planted pre-glitch pattern,
    normalised (reference: omniverse_tests.py:414-470; numpy, as in JAX):
    (X (num_sequences, seq_len) f32, y (num_sequences,) f32)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(85.0, 5.0, size=(num_sequences, seq_len)).astype(
        np.float32)
    y = (rng.random(num_sequences) < 0.5).astype(np.float32)
    # plant a pre-glitch pattern: decaying RSI + oscillation near the end
    for i in range(num_sequences):
        if y[i] > 0.5:
            t = np.arange(8)
            X[i, -8:] -= 3.0 * t
            X[i, -8:] += 4.0 * np.sin(t * 2.0)
    X = (X - X.mean()) / X.std()
    return X, y


def neural_hardware_bridge(num_sequences: int = 400, seq_len: int = 32,
                           epochs: int = 20, seed: int = 42,
                           device=None) -> dict:
    """(reference: omniverse_tests.py:414-632): train an LSTM to predict
    glitches from synthetic RSI sequences with planted pre-glitch
    patterns; report accuracy/precision/recall/F1."""
    device = _resolve_device(device)
    print("\n--- OMNIVERSE 3: NEURAL HARDWARE BRIDGE ---")
    X, y = glitch_sequences(num_sequences, seq_len, seed)
    Xt = torch.as_tensor(X, device=device)[..., None]
    yt = torch.as_tensor(y, device=device)
    split = int(num_sequences * 0.8)

    params = _lstm_init(seed_key(seed), 1, LSTM_HIDDEN, 1, device)
    for _ in range(epochs):
        params = _sgd_step(params, Xt[:split], yt[:split], LSTM_LR)

    with torch.no_grad():
        preds = to_host(_lstm_apply(params, Xt[split:]) > 0.0)
    truth = y[split:] > 0.5
    tp = int((preds & truth).sum())
    fp = int((preds & ~truth).sum())
    fn = int((~preds & truth).sum())
    acc = float((preds == truth).mean())
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    learned = acc > 0.8
    print(f"  accuracy={acc:.2f} precision={prec:.2f} recall={rec:.2f} "
          f"F1={f1:.2f} ({'PATTERN LEARNED' if learned else 'no signal'})")
    return {"accuracy": acc, "precision": prec, "recall": rec, "f1": f1,
            "glitches_predictable": bool(learned)}


# --------------------------------------------------------------------------
# 4. Voxel space-time grid
# --------------------------------------------------------------------------

VOXEL_STARS = 128


def voxel_spacetime_grid(grid_side: int = 4, num_ticks: int = 100,
                         seed: int = 42, device=None) -> dict:
    """(reference: omniverse_tests.py:653-819): run a mini-sim per voxel
    of a spatial grid, score each by drift, map spatial anisotropy."""
    device = _resolve_device(device)
    print("\n--- OMNIVERSE 4: VOXEL SPACE-TIME GRID ---")
    drifts = np.zeros((grid_side, grid_side))
    for i in range(grid_side):
        for j in range(grid_side):
            pos, vel, m = create_disk_galaxy(
                seed_key(seed + i * grid_side + j), VOXEL_STARS)
            offset = torch.tensor([(i - grid_side / 2) * 100.0,
                                   (j - grid_side / 2) * 100.0])
            sim = DirectSimulation(torch.as_tensor(pos) + offset[None, :],
                                   vel, m, precision=Precision.FLOAT32,
                                   force_impl="dense", device=device)
            e0 = sim.get_total_energy()
            sim.step(num_ticks)
            drifts[i, j] = abs((sim.get_total_energy() - e0) / e0)
    gx, gy = np.gradient(drifts)
    anisotropy = float(np.sqrt(gx ** 2 + gy ** 2).mean())
    spatial_variation = float(drifts.std() / max(drifts.mean(), 1e-12))
    print(f"  voxel drift: mean {drifts.mean():.2e}, "
          f"spatial variation {spatial_variation:.2f}, "
          f"anisotropy gradient {anisotropy:.2e}")
    return {"drift_map": drifts.tolist(),
            "spatial_variation": spatial_variation,
            "anisotropy_gradient": anisotropy,
            "space_is_uniform": bool(spatial_variation < 1.0)}


def suite_sizes(quick: bool) -> dict:
    """Each probe's size at --quick or at the full defaults (reference:
    omniverse_tests.py:839-978)."""
    return {"mirror_depth": 30 if quick else 60,
            "fluid_particles": 5000 if quick else 20000,
            "fluid_ticks": 100 if quick else 200,
            "sequences": 200 if quick else 400,
            "epochs": 10 if quick else 20,
            "voxel_side": 3 if quick else 4,
            "voxel_ticks": 60 if quick else 100}


def run_omniverse_suite(quick: bool = False, seed: int = 42,
                        device=None) -> dict:
    """(reference: omniverse_tests.py:839-978)"""
    device = _resolve_device(device)
    s = suite_sizes(quick)
    report = {
        "recursive_mirror": recursive_physics_mirror(
            s["mirror_depth"], seed, device=device),
        "fluid_chaos": fluid_dynamics_chaos(
            s["fluid_particles"], s["fluid_ticks"], seed, device=device),
        "neural_bridge": neural_hardware_bridge(
            s["sequences"], epochs=s["epochs"], seed=seed, device=device),
        "voxel_grid": voxel_spacetime_grid(
            s["voxel_side"], s["voxel_ticks"], seed, device=device),
    }
    score = sum([
        report["recursive_mirror"]["breakdown_depth"] is not None,
        report["fluid_chaos"]["lod_cheating_detected"],
        report["neural_bridge"]["glitches_predictable"],
        not report["voxel_grid"]["space_is_uniform"],
    ])
    report["suite_score"] = {
        "positive_probes": score,
        "conclusion": f"{score}/4 structural probes returned anomalies",
    }
    print(f"\nOMNIVERSE SCORE: {report['suite_score']['conclusion']}")
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Omniverse structural probes")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="output/omniverse")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda unless given; cpu for the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    print("\n" + "=" * 60)
    print("OMNIVERSE TESTS")
    print("=" * 60)
    report = run_omniverse_suite(args.quick, args.seed, device=args.device)
    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    (out / "omniverse_report.json").write_text(
        json.dumps(report, indent=2, default=str))
    return report


if __name__ == "__main__":
    main()

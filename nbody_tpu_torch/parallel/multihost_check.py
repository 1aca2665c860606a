"""Check of the ring across real processes (gloo, one host).

PyTorch counterpart of ``tools/multihost_check.py``. Each process owns
``--shards-per-process`` virtual shards on ``--device``
(``ParticleMesh.virtual``); ``multihost.make_global_mesh`` joins them into
one mesh of S shards, and every collective of the ring then crosses a
real process boundary. Every process builds the same ICs and runs the
same program:

1. the float32 flagship history (``ring.run_with_snapshots_sharded``, sym
   schedule, the equal-mass tiles by ``DirectSimulation``'s rule): the
   force ring, the energy ring and the gathered structure metrics;
2. an int4 run of 5 steps with quantized forces: the global log-grid
   bounds ring crosses processes;
3. a float32 run of 5 steps on the rows schedule (pair_force);
4. ``multihost.cross_host_state_agreement`` on the final state, then on a
   view perturbed on process 1 only, which every process must see fail.

Each process writes a JSON result: topology, energies, frame shape, the
final states' ``hash_state``, this process's kernel launches, the wall of
each part and the part of it spent in the collectives that stage through
gloo (``transport``, timed from a device sync). ``run_parts`` runs the
same parts on any mesh, so a single-controller run of S shards is the
oracle the processes must match bit for bit. ``launch`` spawns the processes and collects their results.

Two processes of 4 shards on the CPU (``--device cuda``, the default,
raises without a card):

    python -m nbody_tpu_torch.parallel.multihost_check --device cpu \\
        --process-id 0 --port 29871 --out p0.json &
    python -m nbody_tpu_torch.parallel.multihost_check --device cpu \\
        --process-id 1 --port 29871 --out p1.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.galaxy import create_disk_galaxy
from nbody_tpu_torch.models.state import make_state
from nbody_tpu_torch.ops import hopper_nbody as hn
from nbody_tpu_torch.ops.precision import Quantizer
from nbody_tpu_torch.parallel import multihost, ring
from nbody_tpu_torch.utils.reproducibility import hash_state

REPO = Path(__file__).resolve().parents[2]
SHORT_STEPS = 5   # the int4 and rows runs (JAX's int4 run)
# A free port can be taken before process 0 binds it: such a failure is
# retried on a fresh port.
BIND_RACE = ("address already in use", "eaddrinuse", "failed to bind")


def make_ics(stars: int, device) -> tuple:
    """The disk of ``stars`` stars from a generator seeded 0: the same
    tensors in every process."""
    return create_disk_galaxy(torch.Generator().manual_seed(0),
                              num_stars=stars, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _timed_transport(mesh: ring.ParticleMesh, seconds: list):
    """Add to seconds[0] the time spent in the ring's collectives across
    processes (each timed from a device sync, so that no wait for queued
    kernels is counted)."""
    names = ("_all_gather_shards", "_rotate_across")
    saved = {name: getattr(ring, name) for name in names}

    def timed(fn):
        def wrapper(*args, **kw):
            _sync(mesh.home)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                seconds[0] += time.perf_counter() - t0
        return wrapper

    for name in names:
        setattr(ring, name, timed(saved[name]))
    try:
        yield
    finally:
        for name in names:
            setattr(ring, name, saved[name])


def run_parts(mesh: ring.ParticleMesh, pos, vel, m, ticks: int, chunks: int,
              process_id: int = 0) -> dict:
    """The check's four parts on ``mesh`` from the ICs (pos, vel, m):
    energies, frame shape and final hashes, the kernel launches and the
    ring's TRAFFIC counts of this process, the wall of each part (s) and
    its time in the collectives across processes (s; 0 on a single
    controller)."""
    stars = pos.shape[0]
    cfg = SimConfig()
    q32, q4 = Quantizer.from_string("float32"), Quantizer.from_string("int4")
    uniform = bool(m.numel() > 0 and (m == m[0]).all())
    out, walls, launches, transport, traffic = {}, {}, {}, {}, {}

    def part(name, fn):
        before, moved = dict(hn.LAUNCHES), dict(ring.TRAFFIC)
        seconds = [0.0]
        t0 = time.perf_counter()
        with _timed_transport(mesh, seconds):
            result = fn()
        _sync(mesh.home)
        walls[name] = time.perf_counter() - t0
        transport[name] = seconds[0]
        launches[name] = {k: v - before[k] for k, v in hn.LAUNCHES.items()
                          if v != before[k]}
        traffic[name] = {k: v - moved[k] for k, v in ring.TRAFFIC.items()}
        return result

    state, snaps, frames = part("history", lambda: (
        ring.run_with_snapshots_sharded(
            make_state(pos, vel, m), q32, cfg, mesh,
            steps_per_chunk=max(ticks // chunks, 1), num_chunks=chunks,
            uniform_gm=uniform)))
    total = [float(x) for x in snaps.total]
    out["energy_total"] = total
    out["drift_pct"] = [(e - total[0]) / abs(total[0]) * 100.0
                        for e in total]
    out["frames_shape"] = list(frames.shape)
    pos_f, vel_f = state.positions[:stars], state.velocities[:stars]
    out["final_hash"] = hash_state(pos_f, vel_f)

    state4, es4 = part("int4", lambda: ring.run_steps_sharded(
        make_state(pos, vel, m), q4, cfg, mesh, num_steps=SHORT_STEPS,
        quantize_forces=True, steps_per_chunk=SHORT_STEPS,
        uniform_gm=uniform))
    out["int4_total"] = [float(x) for x in es4.total]
    out["int4_finite"] = bool(torch.isfinite(es4.total).all())
    out["int4_hash"] = hash_state(state4.positions, state4.velocities)

    state_r, es_r = part("rows", lambda: ring.run_steps_sharded(
        make_state(pos, vel, m), q32, cfg, mesh, num_steps=SHORT_STEPS,
        steps_per_chunk=SHORT_STEPS, schedule="rows"))
    out["rows_total"] = [float(x) for x in es_r.total]
    out["rows_hash"] = hash_state(state_r.positions, state_r.velocities)

    def agreement():
        agree = multihost.cross_host_state_agreement(pos_f, vel_f)
        # Perturb this process's local view on process 1 only: every
        # process must see the gathered digests differ.
        bad = pos_f + (1e-3 if process_id == 1 else 0.0)
        return agree, multihost.cross_host_state_agreement(bad, vel_f)

    out["agree"], out["mismatch"] = part("agreement", agreement)
    out.update(launches=launches, walls=walls, transport=transport,
               traffic=traffic)
    return out


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r}: CUDA is not available here "
                           f"(pass --device cpu to run on the CPU)")
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--shards-per-process", type=int, default=4)
    ap.add_argument("--stars", type=int, default=200)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = _device(args.device)
    active = multihost.initialize_multihost(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.num_processes, process_id=args.process_id)
    mesh = multihost.make_global_mesh(
        local=ring.ParticleMesh.virtual(args.shards_per_process, device))
    result = {"process_id": args.process_id, "multihost_active": active,
              "num_processes": multihost.process_count(),
              "global_shards": mesh.size, "local_shards": len(mesh.local),
              "device": str(mesh.home)}
    if not active:
        _write(args.out, dict(result, error="distributed init inactive"))
        return 1
    pos, vel, m = make_ics(args.stars, device)
    result.update(run_parts(mesh, pos, vel, m, args.ticks, args.chunks,
                            args.process_id))
    _write(args.out, result)
    multihost.shutdown()
    return 0


def _write(path, payload) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(num_processes: int, out_dir, worker_args: list,
           timeout: float, env=None, attempts: int = 3) -> list:
    """Run ``num_processes`` processes of this check on one host, on a
    free port, and return their JSON results in process order. A process
    that exits non-zero ends the others (they would wait in a collective)
    and raises RuntimeError with its log's tail; past ``timeout`` seconds
    every process is ended and TimeoutError raised. A lost race for the
    port is retried on a fresh one, up to ``attempts`` ports."""
    out_dir = Path(out_dir)
    env = dict(os.environ if env is None else env)
    for attempt in range(attempts):
        port = free_port()
        outs, logs = ([out_dir / f"p{pid}_{port}.{ext}"
                       for pid in range(num_processes)]
                      for ext in ("json", "log"))
        procs = []
        for pid in range(num_processes):
            with open(logs[pid], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "nbody_tpu_torch.parallel.multihost_check",
                     "--process-id", str(pid),
                     "--num-processes", str(num_processes),
                     "--port", str(port), "--out", str(outs[pid]),
                     *worker_args],
                    cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        _wait(procs, timeout)
        texts = [p.read_text(errors="replace") for p in logs]
        # A process's own failure (rc > 0) before those ended for it.
        failed = sorted((pid for pid, p in enumerate(procs) if p.returncode),
                        key=lambda pid: procs[pid].returncode < 0)
        if failed and attempt + 1 < attempts and any(
                marker in texts[pid].lower() for pid in failed
                for marker in BIND_RACE):
            continue
        break
    if failed:
        pid = failed[0]
        raise RuntimeError(f"process {pid} of {num_processes} exited "
                           f"{procs[pid].returncode}:\n{texts[pid][-3000:]}")
    return [json.loads(out.read_text()) for out in outs]


def _wait(procs: list, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(procs)} processes of "
                                   f"multihost_check still running after "
                                   f"{timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""aq-facilities -> aq-tonnage on the whole evaluation world, and a profile
of the bootstrap at the paper's scale, on one card.

    python3 scripts/tonnage_world.py [--lon-max 7.5] [--cpu] [--no-profile] [--device cuda|cpu] [--out PATH]

Writes ``chip_smoke.py``'s evaluation world and the tonnage world cut from
it (``write_tonnage_world``: an image box per tile and survey year, a
bathymetry GeoTIFF, a factor workbook, FAO production, Trujillo points),
keeping the detections and labels west of ``--lon-max`` (the world spans
3.0-7.5 E, so the default keeps all of it; ``chip_smoke.py``'s
``facilities_tonnage`` phase cuts it at 3.25 E). Then it times, in this
process, ``cli.facilities`` and ``cli.tonnage --K 10000`` on ``--device``.
``--cpu`` runs both again with ``--device cpu`` (``cli.tonnage`` at
K = 2,000): the facility frames must be equal and each pass's mean within 4
standard errors, as in the phase. ``cli.facilities`` on ``--device`` runs
on both overlay sweep engines ("c++", the default, and "python";
``geo.boolean.using_sweep_engine``): the frames must be equal, and each
run reports its seconds and the seconds spent inside the lattice sweeps
(``geo.boolean._lattice_sweep``, timed by a wrapper). Unless ``--no-profile``, it profiles
``run_bootstrap`` on the card over ``chip_smoke.py``'s paper-scale lattice
(K = 10,000, 16,384 cage pairs, 512 facilities, 6 passes) with
``chip_smoke.profile_step``: the host's wall ms per call, kernel ms by
kind, kernels per call, the top kernels and the card's idle share.

One JSON line per part, each with the card's name and power limit; the
same lines go to ``--out`` if given. Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def timed_sweeps():
    """Count the lattice sweeps of geo.boolean and sum their seconds."""
    from aquaculture_tpu_torch.geo import boolean

    acc = {"sweeps": 0, "sweep_s": 0.0}
    sweep = boolean._lattice_sweep

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return sweep(*args, **kwargs)
        finally:
            acc["sweeps"] += 1
            acc["sweep_s"] += time.perf_counter() - t0

    boolean._lattice_sweep = timed
    try:
        yield acc
    finally:
        boolean._lattice_sweep = sweep


def facilities(paths: dict, pkl: str, device: str, engine: str) -> tuple:
    """cli.facilities on ``device`` with the overlay sweep on ``engine``:
    the facility, its seconds, and the sweeps' count and seconds."""
    from aquaculture_tpu_torch.cli import facilities as cli_facilities
    from aquaculture_tpu_torch.geo import boolean

    with boolean.using_sweep_engine(engine), timed_sweeps() as acc:
        t0 = time.perf_counter()
        fac = cli_facilities.main(cs._facilities_argv(paths, pkl, device))
        seconds = time.perf_counter() - t0
    return fac, {"engine": engine, "cli_facilities_s": seconds, **acc, "sweep_share": acc["sweep_s"] / seconds}


def drive(paths: dict, d: str, device: str, k: int) -> tuple:
    """cli.facilities (the default sweep engine, "c++") then cli.tonnage at
    ``k`` on ``device``: the facility, the tonnage table, each CLI's seconds
    and the facilities run's sweep timing."""
    from aquaculture_tpu_torch.cli import tonnage as cli_tonnage

    pkl = os.path.join(d, f"facility_{device}.pkl")
    fac, sweeps = facilities(paths, pkl, device, "c++")
    t1 = time.perf_counter()
    est = cli_tonnage.main(cs._tonnage_argv(paths, pkl, os.path.join(d, f"tonnage_{device}.csv"), k, device))
    return fac, est, sweeps, time.perf_counter() - t1


def profile_bootstrap_lattice(dev) -> dict:
    """Where run_bootstrap's time goes at the paper's scale. The call ends in
    a copy to the host, so its wall clock spans the card's work."""
    from aquaculture_tpu_torch.tonnage.bootstrap import prepare_bootstrap_inputs, run_bootstrap

    inputs = prepare_bootstrap_inputs(*cs.bootstrap_lattice(0), "pass")
    run_bootstrap(inputs, 0, cs.LATTICE_K, 5.0, 0.85, device=dev)
    prof = cs.profile_step(lambda: run_bootstrap(inputs, 0, cs.LATTICE_K, 5.0, 0.85, device=dev), n=2)
    prof["idle_share"] = 1.0 - prof["device_busy_ms_per_step"] / prof["host_enqueue_ms_per_step"]
    return {"K": cs.LATTICE_K, "pairs": cs.LATTICE_N, "facilities": cs.LATTICE_M, "passes": cs.LATTICE_PASSES,
            **prof}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lon-max", type=float, default=7.5, help="keep detections and labels west of this")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cpu", action="store_true", help="also run both CLIs with --device cpu and compare")
    ap.add_argument("--no-profile", action="store_true", help="skip the bootstrap profile")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: --device cuda needs an NVIDIA GPU")
    card = cs.card_line() if torch.cuda.is_available() else "no GPU"
    lines = []

    def emit(obj: dict) -> None:
        lines.append(json.dumps({**obj, "card": card}))
        print(lines[-1], flush=True)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        world = cs.write_evaluation_world(d)
        paths = cs.write_tonnage_world(d, world=world, lon_max=args.lon_max)
        world_s = time.perf_counter() - t0
        fac, est, sweeps, ton_s = drive(paths, d, args.device, cs.TONNAGE_K_CLI)
        final = fac.final_facilities
        emit({"part": "cli", "device": args.device, "lon_max": args.lon_max, **paths["counts"],
              "kept_detections": int(len(fac.preds)), "facilities": int(len(final)),
              "cages": int(len(fac.facility_cages)), "passes": sorted(set(final["pass"])),
              "world_s": world_s, "cli_facilities_s": sweeps["cli_facilities_s"], "cli_tonnage_s": ton_s,
              "K": cs.TONNAGE_K_CLI, "sweeps": sweeps, "tonnage": est.round(2).to_dict("index")})
        # the same cli.facilities on the Python sweep: equal frames, both engines' seconds
        fac_py, sweeps_py = facilities(paths, os.path.join(d, "facility_python.pkl"), args.device, "python")
        mine, python = cs.facility_tables(fac), cs.facility_tables(fac_py)
        equal = list(mine) == list(python) and all(mine[k].equals(python[k]) for k in python)
        emit({"part": "engines", "device": args.device, "cxx": sweeps, "python": sweeps_py,
              "python_over_cxx_s": sweeps_py["cli_facilities_s"] / sweeps["cli_facilities_s"],
              "equal_facilities": bool(equal)})
        if not equal:
            cs.fail("cli.facilities on the c++ and python sweep engines gave different facility frames")
        if args.cpu:
            fac_cpu, est_cpu, sweeps_cpu, ton_cpu_s = drive(paths, d, "cpu", cs.TONNAGE_K_CPU)
            fac_cpu_s = sweeps_cpu["cli_facilities_s"]
            mine, ref = cs.facility_tables(fac), cs.facility_tables(fac_cpu)
            equal = list(mine) == list(ref) and all(mine[k].equals(ref[k]) for k in ref)
            se = np.sqrt(est["tonnage_var"].to_numpy(np.float64) / cs.TONNAGE_K_CLI
                         + est_cpu["tonnage_var"].to_numpy(np.float64) / cs.TONNAGE_K_CPU)
            z = np.abs(est["tonnage"].to_numpy(np.float64) - est_cpu["tonnage"].to_numpy(np.float64)) / se
            emit({"part": "cpu", "cli_facilities_s": fac_cpu_s, "cli_tonnage_s": ton_cpu_s, "K": cs.TONNAGE_K_CPU,
                  "equal_facilities": bool(equal), "max_z": float(z.max())})
            if not equal or list(est.index) != list(est_cpu.index) or not (z < 4).all():
                cs.fail(f"--device {args.device} vs cpu: facilities equal {equal}, z {z}")
    if not args.no_profile:
        emit({"part": "bootstrap_profile", **profile_bootstrap_lattice(torch.device("cuda", 0))})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

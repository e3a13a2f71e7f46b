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
standard errors, as in the phase. Unless ``--no-profile``, it profiles
``run_bootstrap`` on the card over ``chip_smoke.py``'s paper-scale lattice
(K = 10,000, 16,384 cage pairs, 512 facilities, 6 passes) with
``chip_smoke.profile_step``: the host's wall ms per call, kernel ms by
kind, kernels per call, the top kernels and the card's idle share.

One JSON line per part, each with the card's name and power limit; the
same lines go to ``--out`` if given. Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def drive(paths: dict, d: str, device: str, k: int) -> tuple:
    """cli.facilities then cli.tonnage at ``k`` on ``device``: the facility,
    the tonnage table and each CLI's seconds."""
    from aquaculture_tpu_torch.cli import facilities as cli_facilities
    from aquaculture_tpu_torch.cli import tonnage as cli_tonnage

    pkl = os.path.join(d, f"facility_{device}.pkl")
    t0 = time.perf_counter()
    fac = cli_facilities.main(cs._facilities_argv(paths, pkl, device))
    t1 = time.perf_counter()
    est = cli_tonnage.main(cs._tonnage_argv(paths, pkl, os.path.join(d, f"tonnage_{device}.csv"), k, device))
    return fac, est, t1 - t0, time.perf_counter() - t1


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
        fac, est, fac_s, ton_s = drive(paths, d, args.device, cs.TONNAGE_K_CLI)
        final = fac.final_facilities
        emit({"part": "cli", "device": args.device, "lon_max": args.lon_max, **paths["counts"],
              "kept_detections": int(len(fac.preds)), "facilities": int(len(final)),
              "cages": int(len(fac.facility_cages)), "passes": sorted(set(final["pass"])),
              "world_s": world_s, "cli_facilities_s": fac_s, "cli_tonnage_s": ton_s, "K": cs.TONNAGE_K_CLI,
              "tonnage": est.round(2).to_dict("index")})
        if args.cpu:
            fac_cpu, est_cpu, fac_cpu_s, ton_cpu_s = drive(paths, d, "cpu", cs.TONNAGE_K_CPU)
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

"""Multi-pod dry-run CLI (deliverable e).

Port of ``repro/launch/dryrun.py``.  Traces every (architecture ×
input-shape) cell on the single-pod (16×16) and multi-pod (2×16×16)
production meshes, printing each cell's memory record and writing the
full matrix to results/dryrun/<mesh>.json.

The dry-run is shape-only by design, as the reference's ``jax.eval_shape``
is: its meshes are one ``meta`` device repeated over their 256 or 512
positions, every tensor of a cell lies on ``meta``, and nothing is
allocated or launched.  So it needs neither a card nor the reference's
``XLA_FLAGS`` line, and runs on the CPU.  What each record counts is said
in ``repro_torch.launch.dryrun_lib``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun                  # full 2×40 matrix
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi_pod --probe
"""

import argparse


def main() -> None:
    import torch

    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch.dryrun_lib import run_matrix, run_probe_matrix
    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", action="append", choices=list(ARCH_IDS), default=None)
    ap.add_argument("--shape", action="append", choices=list(SHAPES), default=None)
    ap.add_argument(
        "--mesh",
        choices=["single_pod", "multi_pod", "both"],
        default="both",
    )
    ap.add_argument(
        "--probe",
        action="store_true",
        help="roofline probes: two unrolled-depth traces per cell, "
        "extrapolated to full depth (writes <out>/probe_<mesh>.json)",
    )
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args()

    arches = args.arch or list(ARCH_IDS)
    shapes = args.shape or list(SHAPES)
    meta = (torch.device("meta"),)
    meshes = []
    if args.mesh in ("single_pod", "both"):
        meshes.append(("single_pod", make_production_mesh(multi_pod=False, devices=meta)))
    if args.mesh in ("multi_pod", "both"):
        meshes.append(("multi_pod", make_production_mesh(multi_pod=True, devices=meta)))

    for label, mesh in meshes:
        if args.probe:
            results = run_probe_matrix(
                arches, shapes, [(label, mesh)],
                out_path=f"{args.out}/probe_{label}.json",
            )
        else:
            results = run_matrix(
                arches, shapes, [(label, mesh)], out_path=f"{args.out}/{label}.json"
            )
        ok = sum(r["status"] == "OK" for r in results)
        skip = sum(r["status"] == "SKIP" for r in results)
        fail = sum(r["status"] == "FAIL" for r in results)
        print(f"== {label}: {ok} OK / {skip} SKIP / {fail} FAIL ==", flush=True)


if __name__ == "__main__":
    main()

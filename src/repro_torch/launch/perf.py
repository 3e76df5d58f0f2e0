"""§Perf hillclimb: run named variants of one (arch × shape) cell and
report the three roofline terms + peak memory, before/after.

Port of ``repro/launch/perf.py``: each variant is one hypothesis from
EXPERIMENTS.md §Perf.  The whole step's record gives the peak-bytes/rank
lower bound; the probe traces give the extrapolated roofline terms, here
over an H100 SXM's rates (``repro_torch.analysis.roofline.H100_SXM``).  The
cells are traced on ``meta`` (``repro_torch.launch.dryrun_lib``), so this
runs on the CPU.  Variants the port's rank program does not distinguish
(``sp``: the port's values are whole, and the rules constrain nothing) give
the baseline's numbers.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2-72b --shape train_4k \\
        --variant baseline --variant sp --variant nb16 --variant sp+nb16
    PYTHONPATH=src python -m repro_torch.launch.perf --arch deepseek-7b --shape decode_32k \\
        --variant baseline --variant dus
"""

import argparse
import json
import os


# variant name -> kwargs for run_cell / probe_cell
def variant_kwargs(name: str) -> tuple[dict, dict]:
    kw: dict = {"overrides": {}}
    probe_only: dict = {}
    for part in name.split("+"):
        if part == "baseline":
            pass
        elif part.startswith("nb"):
            kw["num_blocks"] = int(part[2:])
        elif part == "sp":
            kw["sp"] = True
        elif part in ("dus", "hdus", "dec"):
            tag = {"dus": "sharded_dus", "hdus": "heads_dus",
                   "dec": "decomposed"}[part]
            prev = kw.get("cache_impl", "")
            kw["cache_impl"] = (prev + "+" + tag) if prev else tag
        elif part == "hoist":
            kw["hoist"] = True
        elif part.startswith("pb"):  # probe the block loop unrolled N deep
            probe_only["probe_blocks"] = int(part[2:])
        elif part.startswith("remat_"):
            kw["overrides"]["remat"] = part[len("remat_"):]
        elif part.startswith("moeg"):
            kw["overrides"]["moe_group"] = int(part[4:])
        elif part.startswith("cf"):
            kw["overrides"]["moe_capacity_factor"] = float(part[2:])
        elif part == "flash":
            kw["overrides"]["attn_impl"] = "flash"
        else:
            raise KeyError(f"unknown variant component {part!r}")
    if not kw["overrides"]:
        kw.pop("overrides")
    return kw, probe_only


def main() -> None:
    import torch

    from repro_torch.analysis.roofline import H100_SXM, model_flops
    from repro_torch.launch.dryrun_lib import probe_cell, run_cell
    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--mesh", choices=["single_pod", "multi_pod"],
                    default="single_pod")
    ap.add_argument("--out", default=None, help="append JSON rows here")
    ap.add_argument("--no-probe", action="store_true",
                    help="the whole step's record only (peak memory, fast)")
    args = ap.parse_args()

    mesh = make_production_mesh(multi_pod=args.mesh == "multi_pod",
                                devices=(torch.device("meta"),))
    hw = H100_SXM
    rows = []
    hdr = (f"{'variant':16s} {'peakGB/dev':>10s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'coll_s':>10s} {'dominant':>10s} {'MFU':>6s}")
    print(f"== {args.arch} × {args.shape} on {args.mesh} ({hw.name}) ==")
    print(hdr, flush=True)
    mf = model_flops(args.arch, args.shape)
    for name in args.variant:
        kw, probe_only = variant_kwargs(name)
        rec = run_cell(args.arch, args.shape, mesh, mesh_label=args.mesh, **kw)
        row = {"variant": name, **rec}
        if rec["status"] == "OK" and not args.no_probe:
            pkw = {k: v for k, v in kw.items() if k != "num_blocks"}
            if "num_blocks" in kw and "probe_blocks" not in probe_only:
                # probe the block loop unrolled at the variant's blocking
                probe_only["probe_blocks"] = min(kw["num_blocks"], 16)
            p = probe_cell(
                args.arch, args.shape, mesh, mesh_label=args.mesh,
                **pkw, **probe_only
            )
            if p["status"] == "OK":
                ex = p["extrapolated"]
                terms = {
                    "compute": ex["flops"] / hw.peak_flops,
                    "memory": ex["bytes_accessed"] / hw.hbm_bw,
                    "collective": ex["collective_bytes"] / hw.link_bw,
                }
                dom = max(terms, key=terms.get)
                mfu = (mf / rec["devices"] / hw.peak_flops) / terms[dom]
                row.update(probe=p, terms=terms, dominant=dom, mfu=mfu)
        rows.append(row)
        if "terms" in row:
            t = row["terms"]
            print(f"{name:16s} {rec['memory']['peak_live_bytes']/1e9:10.2f} "
                  f"{t['compute']:10.4f} {t['memory']:10.4f} "
                  f"{t['collective']:10.4f} {row['dominant']:>10s} "
                  f"{row['mfu']:6.3f}", flush=True)
        elif rec["status"] == "OK":
            print(f"{name:16s} {rec['memory']['peak_live_bytes']/1e9:10.2f} "
                  f"{'—':>10s} {'—':>10s} {'—':>10s} {'—':>10s} {'—':>6s}",
                  flush=True)
        else:
            print(f"{name:16s} {rec['status']}: {rec.get('error', '')[:90]}",
                  flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        existing = []
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        with open(args.out, "w") as f:
            json.dump(existing + rows, f, indent=1)


if __name__ == "__main__":
    main()

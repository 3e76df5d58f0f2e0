"""Three-term roofline from the dry-run artifacts (DESIGN.md §6).

Reads the scanned-compile matrix (memory proof + collective schedule) and
the probe matrix (depth-extrapolated per-chip FLOPs / bytes / collective
bytes) and derives, per (arch × shape × mesh):

    compute_term    = FLOPs_per_chip      / hardware.peak_flops
    memory_term     = bytes_per_chip      / hardware.hbm_bw
    collective_term = coll_bytes_per_chip / hardware.link_bw

plus the dominant bottleneck, MODEL_FLOPS = 6·N·D (train) or 2·N·D
(fwd-only), the MODEL/HLO FLOP ratio (remat + dispatch + attention
overhead), and a roofline fraction:

* compute-dominant cells: ``model_flops_time / dominant`` (MFU-style);
* memory-dominant cells:  ``min_bytes_time / dominant`` (BWU-style), where
  min bytes = one bf16 read of active params + decode cache per chip.

Port of ``repro/analysis/roofline.py``.  The reference's module constants
(a TPU v5e's peak, HBM and ICI rates) are a named hardware set here, which
:func:`analyze` takes: :data:`H100_SXM`, the port's default, and
:data:`TPU_V5E`, the reference's own figures, used only to hold the port to
the reference.  The records it reads are ``repro_torch.launch.dryrun_lib``'s
(or the reference's: the keys are the same); what the port's records count
is said there (``cost_basis``, ``collectives_basis``).

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.roofline \
        --dryrun results/dryrun/single_pod.json \
        --probe  results/dryrun/probe_single_pod.json \
        --out results/roofline_single_pod.json --md results/roofline_single_pod.md
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

from repro_torch.configs import SHAPES, get_config


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One chip's peak rates: the three roofline terms' denominators."""

    name: str
    peak_flops: float  # dense bf16 FLOP/s
    hbm_bw: float      # device-memory B/s
    link_bw: float     # B/s a collective's operand bytes leave the chip at


# NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU data sheet (SXM column,
# dense rates, at its 700 W limit): 989 TFLOP/s bf16 on the tensor cores,
# 3.35 TB/s of HBM3, and NVLink 4 at 900 GB/s per GPU, which the sheet counts
# over both directions of its 18 links: 450 GB/s each way.  A collective's
# operand bytes leave the card one way, so the link term uses 450e9.
H100_SXM = Hardware("h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)

# The reference's TPU v5e-class constants (per chip), unchanged: they hold
# the port's analysis to the reference's and describe no run of the port.
TPU_V5E = Hardware("tpu_v5e", peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)

HARDWARE = {hw.name: hw for hw in (H100_SXM, TPU_V5E)}


def model_flops(arch: str, shape_name: str) -> float:
    """6·N_active·D (train) / 2·N_active·D (fwd), D = processed tokens.

    N excludes the input-side embedding table (a gather, not a matmul);
    the LM head matmul keeps its table counted.
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.param_counts()["active"]
    if not cfg.tie_embeddings:
        n -= cfg.padded_vocab * cfg.d_model  # input embedding gather
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def _cache_bytes(cfg, shape) -> float:
    """Exact decode-cache footprint (the minimum bytes a decode step reads)."""
    b = shape.global_batch
    s = shape.seq_len
    total = 0.0
    for seg in cfg.segments():
        for spec in seg.period:
            if spec.mixer in ("attn", "enc_attn"):
                sl = min(s, cfg.sliding_window) if cfg.sliding_window else s
                total += seg.repeats * 2 * b * sl * cfg.num_kv_heads * cfg.resolved_head_dim * 2.0
            elif spec.mixer == "cross_attn":
                m = cfg.encoder_seq if cfg.family == "audio" else cfg.image_tokens
                total += seg.repeats * 2 * b * m * cfg.num_kv_heads * cfg.resolved_head_dim * 2.0
            elif spec.mixer == "mla":
                total += seg.repeats * b * s * (cfg.kv_lora_rank + cfg.rope_head_dim) * 2.0
            elif spec.mixer == "mamba2":
                din = cfg.ssm_expand * cfg.d_model
                nh = din // cfg.ssm_head_dim
                total += seg.repeats * b * (
                    nh * cfg.ssm_head_dim * cfg.ssm_state * 4.0  # fp32 state
                    + (cfg.ssm_conv_width - 1) * (din + 2 * cfg.ssm_state) * 2.0
                )
    return total


def analyze(dryrun: list[dict], probe: list[dict], hardware: Hardware = H100_SXM
            ) -> list[dict[str, Any]]:
    peak, hbm, link = hardware.peak_flops, hardware.hbm_bw, hardware.link_bw
    probes = {(r["arch"], r["shape"], r["mesh"]): r for r in probe}
    rows: list[dict[str, Any]] = []
    for rec in dryrun:
        key = (rec["arch"], rec["shape"], rec["mesh"])
        row: dict[str, Any] = {
            "arch": rec["arch"],
            "shape": rec["shape"],
            "mesh": rec["mesh"],
            "status": rec["status"],
        }
        if rec["status"] == "SKIP":
            row["reason"] = rec.get("reason", "")
            rows.append(row)
            continue
        p = probes.get(key)
        if rec["status"] != "OK" or p is None or p.get("status") != "OK":
            row["status"] = "NO-PROBE" if rec["status"] == "OK" else rec["status"]
            rows.append(row)
            continue
        dev = rec["devices"]
        ex = p["extrapolated"]
        compute_t = ex["flops"] / peak
        memory_t = ex["bytes_accessed"] / hbm
        coll_t = ex["collective_bytes"] / link
        terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
        dominant = max(terms, key=terms.get)
        mf = model_flops(rec["arch"], rec["shape"])
        mf_pc = mf / dev
        ratio = mf_pc / ex["flops"] if ex["flops"] else 0.0
        # roofline fraction: MFU-style for compute-shaped steps; BWU-style
        # (achievable-bytes / modeled-bytes) for decode, whose useful FLOPs
        # are negligible by construction.
        if SHAPES[rec["shape"]].kind == "decode" and dominant == "memory":
            mb = _min_bytes_model(rec["arch"], rec["shape"], dev)
            frac = (mb / hbm) / terms[dominant]
        else:
            frac = (mf_pc / peak) / terms[dominant]
        row.update(
            devices=dev,
            compute_s=compute_t,
            memory_s=memory_t,
            collective_s=coll_t,
            dominant=dominant,
            model_flops=mf,
            model_over_hlo=ratio,
            roofline_fraction=frac,
            peak_gb_per_dev=rec["memory"]["peak_live_bytes"] / 1e9,
            note=_note(dominant, ratio, rec["shape"]),
        )
        rows.append(row)
    return rows


def _min_bytes_model(arch: str, shape_name: str, devices: int) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    total = cfg.param_counts()["active"] * 2.0
    if shape.kind == "decode":
        total += _cache_bytes(cfg, shape)
    return total / devices


def _note(dominant: str, ratio: float, shape: str) -> str:
    if dominant == "compute":
        if ratio < 0.55:
            return ("compute waste (remat/dispatch): relax the remat policy or "
                    "shrink MoE one-hot dispatch groups")
        return "near compute roofline; next win is overlapping the DP reduction"
    if dominant == "memory":
        if shape.startswith("decode") or shape.startswith("long"):
            return ("cache-read bound: keep donation aliasing, avoid f32 upcast "
                    "of KV, consider int8 KV")
        return ("activation traffic: sequence-parallel residual stream + smaller "
                "microbatch blocks (SplIter re-split)")
    return ("collective bound: hierarchical pod-aware reduction, int8 gradient "
            "compression, overlap with backward")


# ---------------------------------------------------------------------------


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | shape | dev | compute_s | memory_s | collective_s | "
           "dominant | MODEL/HLO | roofline | peak GB/dev | note |")
    sep = "|" + "---|" * 11
    out = [hdr, sep]
    for r in rows:
        if r["status"] == "SKIP":
            out.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | — | — | — | — | "
                f"SKIP: {r.get('reason', '')[:60]}… |"
            )
            continue
        if r["status"] != "OK":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — | — | — | — | {r['status']} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['devices']} "
            f"| {r['compute_s']:.4g} | {r['memory_s']:.4g} | {r['collective_s']:.4g} "
            f"| **{r['dominant']}** | {r['model_over_hlo']:.2f} "
            f"| {r['roofline_fraction']:.2f} | {r['peak_gb_per_dev']:.1f} "
            f"| {r['note']} |"
        )
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dryrun", required=True)
    ap.add_argument("--probe", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--md", default=None)
    ap.add_argument("--hardware", choices=sorted(HARDWARE), default=H100_SXM.name)
    args = ap.parse_args()
    with open(args.dryrun) as f:
        dryrun = json.load(f)
    with open(args.probe) as f:
        probe = json.load(f)
    rows = analyze(dryrun, probe, HARDWARE[args.hardware])
    md = to_markdown(rows)
    print(md)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()

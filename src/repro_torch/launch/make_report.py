"""Assemble the dry-run and roofline tables from the sweep's records
(counterpart of :mod:`repro.launch.make_report`), in the H100's terms.

  PYTHONPATH=src python -m repro_torch.launch.make_report \\
      --dryrun dryrun_results.json --calibrate --out experiments_tables.md

The numbers are predictions of ``launch.dryrun`` on the meta device
against an NVIDIA H100 80GB HBM3's data-sheet peaks at 700 W
(``launch.roofline``), not measurements.
"""
import argparse
import json

from repro_torch.configs import all_arch_ids
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def fmt_bytes(b):
    if b is None:
        return "-"
    return f"{b/1e9:.2f}G"


def dryrun_table(results):
    lines = [
        "| arch | shape | mesh | status | meta run s | args/dev | temp/dev | peak/dev | fits 80G "
        "| collectives (AG/AR/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if r["status"] == "skip":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP: {r['reason']} | | | | | | |")
            continue
        if r["status"] == "error":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **FAIL**: {r['error'][:60]} "
                "| | | | | | |")
            continue
        m = r["memory"]
        cc = r["roofline"].get("collective_counts") or {}
        cstr = "/".join(str(cc.get(k, 0)) for k in COLLECTIVES)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {r.get('meta_run_s', '-')} | {fmt_bytes(m['argument_bytes'])} "
            f"| {fmt_bytes(m['temp_bytes'])} | {fmt_bytes(m['peak_bytes'])} "
            f"| {'✓' if m['fits_80GB'] else '✗'} | {cstr} |")
    return "\n".join(lines)


def roofline_table(recs):
    lines = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck | MODEL_FLOPS "
        "| useful/counted | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | SKIP: {r.get('reason', '')} "
                         "| | | | | | |")
            continue
        rl = r["roofline"]
        uf = rl.get("useful_flops_frac")
        # roofline fraction: useful model flops over the machine-time the
        # dominant term implies (how close the step is to the best term)
        t_dom = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
        mf = rl.get("model_flops", 0.0)
        frac = (mf / (r.get("chips", 256) * RL.PEAK_FLOPS)) / t_dom if t_dom else 0.0
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rl['t_compute_s']*1e3:.1f}ms "
            f"| {rl['t_memory_s']*1e3:.1f}ms | {rl['t_collective_s']*1e3:.1f}ms "
            f"| **{rl['bottleneck']}** | {mf:.2e} | {uf:.3f} | {frac:.3f} |")
    return "\n".join(lines)


def summary_table(results):
    """The dry-run in one row an architecture: for each shape, a rank's peak
    GB on each mesh in the order met (✗ where it does not fit 80 GB), and
    the roofline's bottleneck with its time on the first."""
    shapes = list(ST.SHAPES)
    lines = ["| arch | " + " | ".join(shapes) + " |", "|---|" + "---|" * len(shapes)]
    rows: dict = {}
    for r in results:
        rows.setdefault(r["arch"], {}).setdefault(r["shape"], []).append(r)
    for arch, by_shape in rows.items():
        cells = []
        for shape in shapes:
            recs = by_shape.get(shape, [])
            if not recs or recs[0]["status"] == "skip":
                cells.append("skip" if recs else "")
                continue
            if any(x["status"] == "error" for x in recs):
                cells.append("FAIL")
                continue
            peaks = " / ".join(f"{x['memory']['peak_bytes'] / 1e9:.1f}"
                               f"{'' if x['memory']['fits_80GB'] else '✗'}" for x in recs)
            rl = recs[0]["roofline"]
            t = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
            cells.append(f"{peaks} · {rl['bottleneck'][:4]} {t * 1e3:.0f} ms")
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="dryrun_results.json")
    ap.add_argument("--calibrate", action="store_true")
    ap.add_argument("--calib-out", default="roofline_calibrated.json")
    ap.add_argument("--out", default="experiments_tables.md")
    args = ap.parse_args(argv)

    out = []
    with open(args.dryrun) as f:
        results = json.load(f)
    out.append("## Dry-run (raw sweep; predictions for an NVIDIA H100 80GB HBM3)\n")
    out.append(dryrun_table(results))
    out.append("\n\n## Dry-run by architecture (peak GB a rank on each mesh · the first "
               "mesh's bottleneck and its time)\n")
    out.append(summary_table(results))

    if args.calibrate:
        from repro_torch.launch.dryrun import calibrated_roofline

        recs = []
        for arch in all_arch_ids():
            for shape in ST.SHAPES:
                try:
                    rec = calibrated_roofline(arch, shape)
                except Exception as e:  # reported in the table
                    rec = {"arch": arch, "shape": shape, "status": "error",
                           "reason": f"{type(e).__name__}: {e}"}
                recs.append(rec)
                print(arch, shape, rec["status"],
                      rec.get("roofline", {}).get("bottleneck", rec.get("reason", "")))
        with open(args.calib_out, "w") as f:
            json.dump(recs, f, indent=1, default=str)
        out.append("\n\n## Roofline (calibrated, single-pod 16x16; H100 data-sheet peaks)\n")
        out.append(roofline_table(recs))

    with open(args.out, "w") as f:
        f.write("\n".join(out) + "\n")
    print("wrote", args.out)


if __name__ == "__main__":
    main()

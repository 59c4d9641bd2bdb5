"""Hill-climbing driver of the port (counterpart of
:mod:`repro.launch.hillclimb`): per cell, the baseline and a list of
hypothesis-driven variants, each one's roofline terms
(``dryrun.calibrated_roofline``) and memory a rank
(``dryrun.dryrun_cell``), on the meta device in the H100's terms.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell mistral

No placeholder devices are forced: the dry-run needs none.
"""
import argparse
import json

from repro_torch.launch.dryrun import apply_overrides, calibrated_roofline

CELLS = {
    # most collective-bound: FSDP gathers × grad-accum microbatches
    "mistral": {
        "arch": "mistral-large-123b", "shape": "train_4k",
        "iters": [
            ("baseline_accum4_sp", {}),
            ("accum2", {"grad_accum": 2}),
            ("accum1", {"grad_accum": 1}),
            ("accum2_nosp", {"grad_accum": 2, "sp": False}),
        ],
    },
    # the paper's technique cell: sorted EP dispatch knobs + dense baseline
    "qwen3": {
        "arch": "qwen3-moe-30b-a3b", "shape": "train_4k",
        "iters": [
            ("baseline_sorted_chunk8k_cf1.25", {}),
            ("chunk16k", {"moe_chunk": 16384}),
            ("cf1.0", {"moe.capacity_factor": 1.0}),
            ("chunk16k_cf1.0", {"moe_chunk": 16384, "moe.capacity_factor": 1.0}),
        ],
    },
    # collective-dominated decode: cache sharding layout
    "llama3_decode": {
        "arch": "llama3-8b", "shape": "decode_32k",
        "iters": [
            ("baseline_seqsharded_cache", {}),
            ("kv_dup2_headsharded", {"kv_dup": 2}),
            ("kv_dup2_chunk4k", {"kv_dup": 2, "attn_chunk_k": 4096}),
        ],
    },
}


def run_cell(name):
    spec = CELLS[name]
    out = []
    for tag, overrides in spec["iters"]:
        rec = calibrated_roofline(spec["arch"], spec["shape"], overrides=overrides)
        mem = memory_probe(spec["arch"], spec["shape"], overrides)
        rec["iter"] = tag
        rec["overrides"] = overrides
        rec["memory"] = mem
        rl = rec.get("roofline", {})
        print(f"[{name}] {tag}: compute={rl.get('t_compute_s', 0)*1e3:.0f}ms "
              f"memory={rl.get('t_memory_s', 0)*1e3:.0f}ms "
              f"collective={rl.get('t_collective_s', 0)*1e3:.0f}ms "
              f"bottleneck={rl.get('bottleneck')} mem/dev={mem:.1f}GB",
              flush=True)
        out.append(rec)
    return out


def memory_probe(arch, shape, overrides):
    """A rank's peak GB (bytes at rest plus the step's high-water mark) of
    the full-depth dry-run with the overrides applied."""
    import repro_torch.launch.dryrun as DR
    from repro_torch.configs import get_config

    orig = DR.get_config
    DR.get_config = lambda a: apply_overrides(get_config(a), overrides)
    try:
        rec = DR.dryrun_cell(arch, shape, verbose=False)
    finally:
        DR.get_config = orig
    if rec["status"] != "ok":
        return float("nan")
    return rec["memory"]["per_device_estimate"] / 1e9


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="all")
    ap.add_argument("--out", default="hillclimb_results.json")
    args = ap.parse_args(argv)
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    results = {}
    for c in cells:
        results[c] = run_cell(c)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1, default=str)
    print("wrote", args.out)


if __name__ == "__main__":
    main()

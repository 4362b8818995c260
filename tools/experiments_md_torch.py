"""Assemble EXPERIMENTS_torch.md, the port's experiment record, from its
artifacts.  Counterpart of ``benchmarks/experiments_md.py``.

    PYTHONPATH=src python3 tools/experiments_md_torch.py

Sections §Dry-run and §Roofline come from ``experiments/dryrun_torch/``
(``python -m repro_torch.launch.dryrun``); §Kernel-suite and §Triad from
the committed ``BENCH_kernel_suite_h100.json`` and ``BENCH_triad_h100.json``
(``tools/kernel_suite_torch.py``, ``tools/triad_torch.py`` on the card);
§Model-zoo, §Sampled-zoo, §Design-space, §Cluster-scaling and §Serving
from the committed ``BENCH_*_torch.json``.  Those five keep the
reference's schema, and their sections are the reference's functions,
which render the same text on the same file.  The analysis lives in
PERF.md; this file carries none.

EXPERIMENTS_torch.md is committed, so this script is deterministic:
sections whose artifacts are absent (the dry-run's are not committed)
render a stable "run X first" placeholder instead of data.  It never
writes EXPERIMENTS.md, which is the reference's.
"""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(".")
DRY = ROOT / "experiments" / "dryrun_torch"
KERNEL_JSON = ROOT / "BENCH_kernel_suite_h100.json"
TRIAD_JSON = ROOT / "BENCH_triad_h100.json"
ZOO_JSON = ROOT / "BENCH_model_zoo_torch.json"
SAMPLING_JSON = ROOT / "BENCH_sampling_torch.json"
DSE_JSON = ROOT / "BENCH_dse_torch.json"
CLUSTER_JSON = ROOT / "BENCH_cluster_torch.json"
SERVING_JSON = ROOT / "BENCH_serving_torch.json"
OUT = ROOT / "EXPERIMENTS_torch.md"

SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2,
               "long_500k": 3}
ZOO_PHASE_ORDER = {"train": 0, "prefill": 1, "decode": 2}
DRYRUN_CMD = "PYTHONPATH=src python -m repro_torch.launch.dryrun"


def _ranks(values) -> list[int]:
    """1-based rank of each value (ascending; ties broken by position)."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    out = [0] * len(values)
    for rank, i in enumerate(order, 1):
        out[i] = rank
    return out


def rows_for(mesh: str):
    d = DRY / mesh
    rows = [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9)))
    return rows


def dryrun_table(mesh: str) -> str:
    """The reference's table on the port's artifacts: peak per rank from
    ``core.aten.memory_analysis`` against the card's HBM, and the parse's
    and simulation's seconds where the reference has its compile's."""
    rows = rows_for(mesh)
    if not rows:
        return (f"_run `{DRYRUN_CMD}` first (dry-run artifacts are not "
                "committed; this table fills in when they exist locally)_")
    hbm = rows[0]["hbm_per_chip"] / 1e9
    out = ["| arch | shape | kind | chips | GFLOP/dev | GB/dev | commGB/dev "
           f"| peak GiB/dev | fits {hbm:.0f} GB | parse+sim s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        p = r["program"]
        mem = r.get("memory_analysis") or {}
        peak = (mem.get("peak_bytes_est") or 0) / 2**30
        comm = r["roofline"]["comm_bytes_per_device"]
        byts = r["roofline"]["bytes_per_device"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | {r['n_chips']} "
            f"| {p['flops_per_device'] / 1e9:,.0f} | {byts / 1e9:,.1f} "
            f"| {comm / 1e9:,.2f} | {peak:.2f} "
            f"| {'Y' if r.get('fits_hbm') else 'N'} "
            f"| {r['t_compile_s']:.0f} |")
    return "\n".join(out)


def hint_of(r: dict) -> str:
    for line in r.get("pa_report", "").splitlines():
        line = line.strip()
        if line.startswith("- "):
            return line[2:].split(":")[0].split(",")[0]
    return ""


def roofline_table() -> str:
    rows = rows_for("single_pod")
    if not rows:
        return f"_run `{DRYRUN_CMD}` first (see §Dry-run)_"
    out = ["| arch | shape | compute s | memory s | collective s | dominant "
           "| t_est s | roofline frac | MF/HLO | MXU lanes "
           "| what would move it |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        rf = r["roofline"]
        t_est = r.get("engine", {}).get("t_est", 0.0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4f} "
            f"| {rf['memory_s']:.4f} | {rf['collective_s']:.4f} "
            f"| **{rf['dominant']}** | {t_est:.3f} "
            f"| {rf['roofline_fraction']:.2f} "
            f"| {rf['useful_flops_ratio']:.2f} "
            f"| {rf['mxu_utilization']:.2f} | {hint_of(r)} |")
    return "\n".join(out)


def kernel_section() -> str:
    """Fig. 3 from ``BENCH_kernel_suite_h100.json`` (the port's schema: a
    dict of kernels with both engines' estimates)."""
    if not KERNEL_JSON.exists():
        return "_run `PYTHONPATH=src python3 tools/kernel_suite_torch.py` first_"
    d = json.loads(KERNEL_JSON.read_text())
    s, ks = d["summary"], d["kernels"]
    names = list(ks)
    meas = [ks[n]["measured_us"] for n in names]
    sim = [ks[n]["t_est_occupancy_us"] for n in names]
    meas_rank, sim_rank = _ranks(meas), _ranks(sim)
    out = ["| kernel | measured µs | simulated µs | diff % | schedule µs "
           "| bound by | rank meas/sim | fit input |",
           "|---|---|---|---|---|---|---|---|"]
    for i, n in enumerate(names):
        k = ks[n]
        diff = 100.0 * (sim[i] - meas[i]) / meas[i]
        out.append(f"| {n} | {meas[i]:.1f} | {sim[i]:.1f} | {diff:+.1f} "
                   f"| {k['t_est_schedule_us']:.1f} "
                   f"| {k.get('bound_by') or '—'} "
                   f"| {meas_rank[i]}/{sim_rank[i]} "
                   f"| {'*' if k.get('fit_input') else ''} |")
    out.append("")
    out.append(f"**Summary ({len(names)} kernels, {d['hw']} fitted on "
               f"{d['device']}):** mean {s['mean_diff_pct']:+.1f}% · std "
               f"{s['std_diff_pct']:.1f}% · mean |diff| "
               f"{s['mean_abs_diff_pct']:.1f}% · within ±10%: "
               f"{100 * s['within_10pct']:.0f}% (schedule engine: mean "
               f"|diff| {s['sched_mean_abs_diff_pct']:.1f}%, within ±10%: "
               f"{100 * s['sched_within_10pct']:.0f}%) — paper: "
               f"{s['paper']['mean_diff_pct']:+.1f}% · "
               f"{s['paper']['std_diff_pct']:.1f}% · "
               f"{s['paper']['mean_abs_diff_pct']:.1f}% · "
               f"{100 * s['paper']['within_10pct']:.0f}%.")
    return "\n".join(out)


def triad_section() -> str:
    if not TRIAD_JSON.exists():
        return "_run `PYTHONPATH=src python3 tools/triad_torch.py` first_"
    d = json.loads(TRIAD_JSON.read_text())
    out = []
    for name, title in (("triad_l2", "Fig. 4 analogue (L2-resident)"),
                        ("triad_mem", "Fig. 5 analogue (HBM-resident)")):
        n = d[name][0]["n"]
        out.append(f"**{title}**, {3 * 8 * n / 2**20:.0f} MiB")
        out.append("")
        out.append("| CTAs | measured GB/s | simulated GB/s | diff % |")
        out.append("|---|---|---|---|")
        for r in d[name]:
            out.append(f"| {r['ctas']} | {r['measured_gbps']:.2f} "
                       f"| {r['simulated_gbps']:.2f} "
                       f"| {r['diff_pct']:+.1f} |")
        out.append("")
    return "\n".join(out).rstrip()


def cards() -> str:
    """The cards the committed files were measured on (their ``card``)."""
    seen = []
    for p in (KERNEL_JSON, TRIAD_JSON, ZOO_JSON, SAMPLING_JSON, DSE_JSON,
              CLUSTER_JSON, SERVING_JSON):
        if p.exists():
            c = json.loads(p.read_text()).get("card")
            if c and c not in seen:
                seen.append(c)
    return "; ".join(seen) or "no card on record"


def zoo_section() -> str:
    if not ZOO_JSON.exists():
        return "_run `PYTHONPATH=src python -m benchmarks.model_zoo` first_"
    d = json.loads(ZOO_JSON.read_text())
    counts = d["core_counts"]
    ck = [str(c) for c in counts]
    mid = ck[len(ck) // 2]
    out = [f"| model | family | phase | ops | dominant | bound by @{mid}c "
           + "".join(f"| t_est {c}c µs " for c in ck)
           + f"| speedup {ck[0]}→{ck[-1]}c | rank @{mid}c |",
           "|---|---|---|---|---|---|" + "---|" * (len(ck) + 2)]
    models = sorted(d["models"])
    for name in models:
        m = d["models"][name]
        for phase in sorted(m["phases"],
                            key=lambda p: ZOO_PHASE_ORDER.get(p, 9)):
            ph = m["phases"][phase]
            pc = ph["per_core"]
            rank = d["rank"][phase][mid].index(name) + 1
            cells = "".join(f"| {pc[c]['t_est_us']:,.1f} " for c in ck)
            out.append(
                f"| {name} | {m['family']} | {phase} | {ph['n_ops']} "
                f"| {ph['roofline_dominant']} | {pc[mid]['bound_by']} "
                f"{cells}| ×{ph['node_speedup']:.1f} | {rank} |")
    out.append("")
    taus = []
    for phase in d["phases"]:
        t = d["kendall_tau"][phase]
        taus.append(f"{phase} τ_min={t['min']:+.2f} "
                    f"(vs FLOPs {t['vs_flops']:+.2f})")
    out.append(f"**Rank stability (Kendall τ across the core axis):** "
               f"{' · '.join(taus)} — floor 0.5 enforced by "
               f"`tests/test_zoo.py`.")
    return "\n".join(out)


def sampling_section() -> str:
    if not SAMPLING_JSON.exists():
        return ("_run `PYTHONPATH=src python -m benchmarks."
                "sampled_estimation` first_")
    d = json.loads(SAMPLING_JSON.read_text())
    dag = d["bench_dag"]
    out = [f"**Bench DAG** (sched-throughput step ×40, 48 cores): "
           f"scheduled {100 * dag['frac_ops_scheduled']:.1f}% of "
           f"{dag['n_instances']:,.0f} op instances, reconstruction error "
           f"{dag['reconstruction_error_pct']:+.3f}%, wall speedup "
           f"×{dag['speedup']:.1f} (floors: ≥×"
           f"{d['floors']['speedup']:.0f} at ≤"
           f"{100 * d['floors']['frac']:.0f}% within "
           f"{d['floors']['error_pct']:.0f}%).", ""]
    out += ["| model | phase | ops | ×rep | k/ivs | % ops sched "
            "| t_full µs | err % | wall full s | wall sampled s | budget |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    budget = d["floors"]["budget_s"]
    for arch in sorted(d["zoo"]):
        phases = d["zoo"][arch]
        for phase in sorted(phases, key=lambda p: ZOO_PHASE_ORDER.get(p, 9)):
            r = phases[phase]
            gate = ("**blown→ok**" if r["full_exceeds_budget"]
                    and r["sampled_under_budget"] else "ok")
            out.append(
                f"| {arch} | {phase} | {r['n_ops']} "
                f"| {r['trace_repeats']} | {r['k']}/{r['n_intervals']} "
                f"| {100 * r['frac_ops_scheduled']:.1f} "
                f"| {r['t_full_us']:,.1f} "
                f"| {r['reconstruction_error_pct']:+.3f} "
                f"| {r['wall_full_s']:.2f} | {r['wall_sampled_s']:.2f} "
                f"| {gate} |")
    if d.get("kernels"):
        errs = [abs(r["reconstruction_error_pct"])
                for r in d["kernels"].values()]
        fracs = [r["frac_ops_scheduled"] for r in d["kernels"].values()]
        out += ["", f"**Kernel suite** ({len(errs)} programs ×32): "
                f"max |error| {max(errs):.3f}%, fraction scheduled "
                f"{100 * min(fracs):.1f}–{100 * max(fracs):.1f}%."]
    out += ["", f"`budget` gates the *sampled* wall per phase at "
            f"{budget:.0f} s; **blown→ok** marks cells whose unsampled "
            f"pass exceeded it — the affordability claim in one column."]
    return "\n".join(out)


def dse_section() -> str:
    if not DSE_JSON.exists():
        return "_run `PYTHONPATH=src python -m benchmarks.dse_sweep` first_"
    d = json.loads(DSE_JSON.read_text())
    baseline = "c4x12_hbm1_r130_v2"          # the real A64FX grid point
    names = [p["name"] for p in d["spec_points"]]
    base_i = names.index(baseline) if baseline in names else None
    out = ["| workload | ops | best candidate | t_best µs "
           "| A64FX µs | best/A64FX | Pareto size |",
           "|---|---|---|---|---|---|---|"]
    for key in d["workloads"]:
        wl = d["per_workload"][key]
        ts = wl["t_est_s"]
        bi = names.index(wl["best_spec"])
        if base_i is not None:
            base_us = f"{ts[base_i] * 1e6:,.1f}"
            ratio = f"×{ts[base_i] / ts[bi]:.2f}"
        else:
            base_us = ratio = "—"
        out.append(f"| {key} | {wl['n_ops']} | {wl['best_spec']} "
                   f"| {ts[bi] * 1e6:,.1f} | {base_us} | {ratio} "
                   f"| {len(wl['pareto'])}/{d['n_specs']} |")
    rs = d["rank_stability"]
    out += ["", f"**Rank stability across workloads:** mean τ "
            f"{rs['mean_tau']:+.2f}, min {rs['min_tau']:+.2f} over "
            f"{len(d['workloads'])} workload pairs-of-rankings — the "
            f"candidate ordering barely depends on which model you "
            f"benchmark (floors 0.5/0.2, `tests/test_dse.py`)."]
    thr = d.get("throughput")
    if thr:
        out += ["", f"**Throughput** ({thr['workload']}, "
                f"{thr['n_specs']} candidates): fused sweep "
                f"{thr['fused_wall_s'] * 1e3:.0f} ms vs per-spec loop "
                f"{thr['loop_wall_s'] * 1e3:.0f} ms — "
                f"×{thr['speedup']:.1f}, bit-identical; CI pins ≥×"
                f"{thr['floor_speedup']:.0f} on the synthetic twin."]
    return "\n".join(out)


def cluster_section() -> str:
    if not CLUSTER_JSON.exists():
        return ("_run `PYTHONPATH=src python -m benchmarks."
                "cluster_scaling` first_")
    d = json.loads(CLUSTER_JSON.read_text())
    out = []
    for name in sorted(d["models"]):
        m = d["models"][name]
        out.append(f"**{name}**")
        out.append("")
        out.append("| nodes | best plan | t_step ms | efficiency "
                   "| tokens/s | plans priced |")
        out.append("|---|---|---|---|---|---|")
        for n in d["node_counts"]:
            s = m["scaling"].get(str(n))
            if s is None:
                continue
            priced = sum(1 for p in m["plans"].get(str(n), {}))
            out.append(f"| {n} | {s['plan']} "
                       f"| {s['t_step_us'] / 1e3:,.3f} "
                       f"| {s['parallel_efficiency']:.3f} "
                       f"| {s['tokens_per_s']:,.0f} | {priced} |")
        out.append("")
    taus = []
    for name in sorted(d["kendall_tau"]):
        t = d["kendall_tau"][name]
        taus.append(f"{name} τ_min={t['min']:+.2f}")
    out.append(f"**Plan-rank stability (Kendall τ between adjacent node "
               f"counts, common dp×tp×pp shapes):** {' · '.join(taus)} — "
               f"the winning-plan ordering survives the node-count axis, "
               f"so a cheap small-cluster sweep ranks plans for the big "
               f"machine (`tests/test_cluster.py` pins the 2-node "
               f"degenerate case bit-identical to the node engine).")
    return "\n".join(out)


def serving_section() -> str:
    if not SERVING_JSON.exists():
        return ("_run `PYTHONPATH=src python -m benchmarks."
                "serving_sweep` first_")
    d = json.loads(SERVING_JSON.read_text())
    a = d["arrival"]
    out = []
    for name in sorted(d["models"]):
        m = d["models"][name]
        tr = m["traffic"]
        out.append(f"**{name}** — λ={m['rate_per_s']:,.1f} req/s "
                   f"({a['load_factor']}× the batch-1 rate), prompts "
                   f"~{tr['prompt_mean']:,.0f} tok, outputs "
                   f"~{tr['out_mean']:,.0f} tok, KV "
                   f"{m['bytes_per_token'] / 1e3:,.1f} kB/token")
        out.append("")
        out.append("| policy | p50 TTFT ms | p99 TTFT ms | p99 TPOT ms "
                   "| tokens/s | mean batch | evict | rejected |")
        out.append("|---|---|---|---|---|---|---|---|")
        for p in d["policies"]:
            s = m["policies"][p["label"]]
            star = "**" if p["label"] in m["pareto"] else ""
            out.append(
                f"| {star}{p['label']}{star} | {s['p50_ttft_ms']:,.1f} "
                f"| {s['p99_ttft_ms']:,.1f} | {s['p99_tpot_ms']:,.2f} "
                f"| {s['tokens_per_s']:,.1f} "
                f"| {s['mean_decode_batch']:.1f} | {s['n_evictions']} "
                f"| {s['rejected']} |")
        out.append("")
    out.append("**Bold** = on the (p99 TTFT, tokens/s) Pareto front for "
               "that model.  Every run's Little's-law bookkeeping gap is "
               "< 1e-6 (the in-loop ∫N(t)dt vs summed sojourns — "
               "`tests/test_serving.py` pins it at 1e-9).")
    return "\n".join(out)

HEADER = """# EXPERIMENTS (the PyTorch/CUDA port)

GENERATED by `tools/experiments_md_torch.py` from the port's committed
artifacts; regenerate instead of editing.  Measured on: {cards}.  Every
number below is either a measurement on that card or the simulator's
estimate; which is which, and what each run taught, is in PERF.md (its
§5 and §6).  The reference's record is EXPERIMENTS.md.

## §Dry-run — every (arch × shape) captured on the fake production meshes

`{dryrun}` — 32 live cells (+8 documented skips) × 2 meshes, each
captured by `launch.cell.Cell.capture()` over torch's fake process group
of 256 or 512 ranks (nothing runs on a card), parsed by
`core.aten.parse_graph` and simulated on the `H100` spec.  Quantities are
per rank; `peak GiB/dev` is `core.aten.memory_analysis` of the capture.

### Single-pod mesh (16, 16) = 256 ranks — ("data", "model")

{dry_single}

### Multi-pod mesh (2, 16, 16) = 512 ranks — ("pod", "data", "model")

{dry_multi}

## §Roofline — three-term analysis per cell (single-pod, `H100` spec)

`python3 tools/roofline_table_torch.py` prints the same per mesh, with
the peak bytes and the fit.

{roofline}

## §Kernel-suite — paper Table 1 + Fig. 3, K1 on the card

`PYTHONPATH=src python3 tools/kernel_suite_torch.py`

{kernels}

## §Model-zoo — every registry architecture through the node engine

`PYTHONPATH=src python3 tools/model_zoo_torch.py`

{zoo}

## §Sampled-zoo — full-depth traces via SimPoint-style sampling

`PYTHONPATH=src python3 tools/sampled_estimation_torch.py`

{sampling}

## §Design-space — a 64-candidate hardware grid over the zoo

`PYTHONPATH=src python3 tools/dse_sweep_torch.py`

{dse}

## §Cluster-scaling — dp×tp×pp plans over a 2–1024-node torus

`PYTHONPATH=src python3 tools/cluster_scaling_torch.py`

{cluster}

## §Serving — trace-driven continuous batching with SLO percentiles

`PYTHONPATH=src python3 tools/serving_sweep_torch.py`

{serving}

## §Triad — paper Figs. 4/5, K2 on the card

`PYTHONPATH=src python3 tools/triad_torch.py`

{triad}
"""


def render() -> str:
    return HEADER.format(
        cards=cards(), dryrun=DRYRUN_CMD,
        dry_single=dryrun_table("single_pod"),
        dry_multi=dryrun_table("multi_pod"),
        roofline=roofline_table(),
        kernels=kernel_section(),
        zoo=zoo_section(),
        sampling=sampling_section(),
        dse=dse_section(),
        cluster=cluster_section(),
        serving=serving_section(),
        triad=triad_section(),
    )


def main() -> int:
    OUT.write_text(render())
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

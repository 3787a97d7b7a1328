"""Multi-pod dry run: lower EVERY (arch × shape × mesh) cell on meta tensors.

Counterpart of ``repro.launch.dryrun``. For each runnable cell this driver

  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod; its
     devices are ``meta``: one controller holds no 256-chip program),
  2. sanitizes the cell's state, batch and cache spec trees against it and
     sums the per-device argument bytes,
  3. runs the cell's step (train / prefill / decode) on meta tensors at the
     cell's global shape under the mesh (``launch.compile.lower_cell``):
     the torch counterpart of ``.lower()``, with its aten ops, per-device
     output bytes and the Tracker's whole-program live-bytes peak,

into ``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` (resumable:
existing results are skipped unless --force). A cell's meta run is made
once and reused for every mesh that cannot change it.

The reference's records keep their keys where a key keeps its meaning.
There is no compiled HLO: ``collectives``, ``flops`` and ``bytes_accessed``
are null, each with its reason, and no roofline constants are kept. The
HLO text parser (``parse_collectives`` and its helpers) is kept for HLO
text from elsewhere.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --workers 4     # four processes
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import time
import traceback

COLLECTIVE_RE = re.compile(
    r"=\s*(?:\()?(?P<type>[a-z0-9]+)\[(?P<dims>[\d,]*)\]"
    r".*?\s(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
COMP_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*->.*\{\s*$")
WHILE_RE = re.compile(r"\swhile\(.*?condition=%?([\w\.\-]+),\s*body=%?([\w\.\-]+)")
CONST_RE = re.compile(r"constant\((\d+)\)")

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

NO_HLO = ("one controller runs the step eagerly on meta tensors and lowers to no HLO: "
          "there are no collectives to parse")
NO_COST = "no compiled program: no cost analysis"


def _split_computations(hlo_text: str) -> dict:
    """HLO text -> {computation_name: [lines]}."""
    comps = {}
    cur = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        m = COMP_HEADER_RE.match(line) or COMP_HEADER_RE.match(stripped)
        if m and stripped.endswith("{"):
            cur = m.group(1)
            comps[cur] = []
            continue
        if stripped == "}":
            cur = None
            continue
        if cur is not None:
            comps[cur].append(stripped)
    return comps


def _line_collective_bytes(line: str):
    """(op, traffic_bytes) for a collective line, else None.

    Traffic model (ring algorithms, group size g, result bytes R):
      all-gather ≈ R; all-reduce ≈ 2R; reduce-scatter ≈ R*g (input = g*R);
      all-to-all ≈ R; collective-permute ≈ R.
    """
    m = COLLECTIVE_RE.search(line)
    if not m:
        return None
    dt = m.group("type")
    if dt not in DTYPE_BYTES:
        return None
    nbytes = DTYPE_BYTES[dt]
    for d in [int(x) for x in m.group("dims").split(",") if x]:
        nbytes *= d
    g = 1
    gm = GROUPS_RE.search(line)
    if gm:
        g = int(gm.group(2))
    op = m.group("op")
    factor = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": float(g),
              "all-to-all": 1.0, "collective-permute": 1.0}[op]
    return op, nbytes * factor


def _trip_count(cond_lines: list) -> int:
    """Loop bound heuristic: the max integer constant in the while condition
    (a scan lowers to while with `compare(iv, constant(N)), LT`)."""
    best = 1
    for line in cond_lines:
        for c in CONST_RE.findall(line):
            best = max(best, int(c))
    return best


def parse_collectives(hlo_text: str) -> dict:
    """LOOP-AWARE per-device link-traffic estimate per collective type.

    A flat count sees a loop body once; here each while body's collectives
    are multiplied by its trip count (nested loops compose
    multiplicatively), as the reference's.
    """
    comps = _split_computations(hlo_text)
    # per-computation local costs + call edges
    local = {name: {} for name in comps}
    edges = {name: [] for name in comps}  # (child, multiplier)
    for name, lines in comps.items():
        for line in lines:
            got = _line_collective_bytes(line)
            if got:
                op, b = got
                local[name][op] = local[name].get(op, 0.0) + b
                local[name][f"n_{op}"] = local[name].get(f"n_{op}", 0) + 1
            wm = WHILE_RE.search(line)
            if wm:
                cond, body = wm.group(1), wm.group(2)
                trips = _trip_count(comps.get(cond, []))
                edges[name].append((body, trips))
            elif " call(" in line or " conditional(" in line:
                for cm in re.finditer(r"(?:to_apply|branch_computations)=\{?%?([\w\.\-]+)", line):
                    edges[name].append((cm.group(1), 1))

    @functools.lru_cache(maxsize=None)
    def total(name: str):
        acc = dict(local.get(name, {}))
        for child, mult in edges.get(name, []):
            sub = total(child)
            for k, v in sub.items():
                acc[k] = acc.get(k, 0) + v * mult
        return acc

    # entry computation: the one not called by anyone
    called = {c for es in edges.values() for c, _ in es}
    entries = [n for n in comps if n not in called]
    agg = {}
    for e in entries:
        for k, v in total(e).items():
            agg[k] = agg.get(k, 0) + v
    per_type = {k: v for k, v in agg.items() if not k.startswith("n_")}
    counts = {k[2:]: int(v) for k, v in agg.items() if k.startswith("n_")}
    return {
        "per_type_bytes": per_type,
        "counts": counts,
        "total_bytes": float(sum(per_type.values())),
    }


def optimized_overrides(arch_id: str, shape_kind: str) -> dict:
    """The reference's lever set per (arch, cell kind).

    train/prefill: pure-FSDP layout (model axis = extra DP) + all-to-all EP
    for MoE archs. decode: replicated serving layout for dense archs that
    fit (<~10B); MoE archs keep the 2-D expert sharding.
    """
    moe = arch_id.startswith("llama4")
    if shape_kind in ("train", "prefill"):
        over = {"dp_over_model": True}
        if moe:
            over["moe_impl"] = "a2a_shardmap"
        return over
    if not moe:
        return {"serve_param_layout": "replicated", "param_dtype": "bfloat16"}
    return {}


def run_cell(arch_id: str, shape_name: str, mesh_name: str, out_dir: str, force: bool,
             optimized: bool = False, runs: dict | None = None):
    """Lower one cell and write its record; True when it is ok or skipped.
    ``runs`` keeps meta runs for the next cells (``compile.lower_cell``)."""
    from repro_torch.configs import SHAPES, get_bundle
    from repro_torch.launch.compile import lower_cell
    from repro_torch.launch.mesh import make_production_mesh

    out_path = os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_name}.json")
    if os.path.exists(out_path) and not force:
        print(f"[skip] {out_path} exists")
        return True

    bundle = get_bundle(arch_id)
    over = {}
    if optimized and shape_name in SHAPES:
        over = optimized_overrides(arch_id, SHAPES[shape_name].kind)
        if over:
            bundle = dataclasses.replace(
                bundle, model=dataclasses.replace(bundle.model, **over)
            )
    if shape_name in bundle.shape_skips:
        rec = {
            "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
            "status": "skipped", "reason": bundle.shape_skips[shape_name],
        }
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
        print(f"[skip-cell] {arch_id} x {shape_name}: {rec['reason']}")
        return True

    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_name == "pod2"))
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "mesh_shape": dict(mesh.shape),
        "n_devices": int(mesh.size),
        "kind": shape.kind, "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "optimized": optimized, "overrides": over,
    }
    t0 = time.time()
    try:
        cell = lower_cell(bundle, shape, mesh, runs=runs)
        rec["lower_s"] = time.time() - t0
        rec["argument_size_in_bytes"] = cell.argument_size_in_bytes
        rec["output_size_in_bytes"] = cell.output_size_in_bytes
        rec["aten_ops"] = cell.aten_ops
        rec["whole_program_live_bytes_peak"] = cell.whole_program_live_bytes_peak
        rec["meta_run_s"] = cell.meta_run_s
        rec["meta_run_reused"] = cell.meta_run_reused
        rec["collectives"] = None
        rec["collectives_note"] = NO_HLO
        rec["flops"] = rec["bytes_accessed"] = None
        rec["cost_note"] = NO_COST
        rec["status"] = "ok"
        print(
            f"[ok] {arch_id} x {shape_name} x {mesh_name}: "
            f"args/dev={rec['argument_size_in_bytes'] / 2**30:.3f}GiB "
            f"out/dev={rec['output_size_in_bytes'] / 2**30:.3f}GiB "
            f"aten_ops={rec['aten_ops']} "
            f"live_peak(whole program, meta)={rec['whole_program_live_bytes_peak'] / 2**30:.2f}GiB "
            f"(lower {rec['lower_s']:.2f}s"
            + (", meta run reused" if cell.meta_run_reused else "") + ")",
            flush=True,
        )
    except Exception as e:  # record and continue — failures are bugs to fix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch_id} x {shape_name} x {mesh_name}: {rec['error'][:300]}", flush=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec.get("status") in ("ok", "skipped")


def _run_group(arch_id, shape_name, meshes, out_dir, force, optimized):
    """One (arch, shape) over its meshes, in this process (its meta runs
    shared)."""
    runs: dict = {}
    return [run_cell(arch_id, shape_name, m, out_dir, force, optimized, runs) for m in meshes]


def _cost_rank(task) -> tuple:
    """Longest meta runs first: prefill (the blocked attention loops over
    32k tokens), then train, then decode; deeper models first, an encoder's
    attention (no causal skip) counted twice."""
    from repro_torch.configs import SHAPES, get_bundle

    arch, shape = task[0], task[1]
    cfg = get_bundle(arch).model
    kind = SHAPES[shape].kind if shape in SHAPES else "decode"
    return (("prefill", "train", "decode").index(kind),
            -cfg.n_layers * (2 if cfg.encoder_only else 1))


def run_groups(tasks, workers: int = 1) -> bool:
    """``_run_group`` over ``tasks`` ((arch, shape, meshes, out_dir, force,
    optimized) each); with ``workers`` > 1 in that many spawned processes,
    the longest first. True when every cell is ok or skipped."""
    tasks = sorted(tasks, key=_cost_rank)
    if workers <= 1:
        return all([ok for t in tasks for ok in _run_group(*t)])
    import concurrent.futures
    import multiprocessing
    import site
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[2])  # where repro_torch is importable from
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=site.addsitedir, initargs=(src,)) as pool:
        futures = [pool.submit(_run_group, *t) for t in tasks]
        return all([ok for f in futures for ok in f.result()])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch id (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default=None, choices=[None, "pod1", "pod2"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the reference's lever set per cell")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes running (arch, shape) groups side by side")
    args = ap.parse_args(argv)
    if args.optimized and args.out == "results/dryrun_torch":
        args.out = "results/dryrun_torch_opt"

    from repro_torch.configs import SHAPES, list_archs

    os.makedirs(args.out, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["pod1", "pod2"]

    ok = run_groups([(a, s, meshes, args.out, args.force, args.optimized)
                     for a in archs for s in shapes], args.workers)
    print("DRYRUN", "PASS" if ok else "FAIL")
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()

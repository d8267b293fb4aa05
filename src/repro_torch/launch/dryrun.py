"""Dry-run: size every (arch x shape x mesh) cell on the meta device.

    python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all [--mesh both] [--force]

The reference (``repro/launch/dryrun.py``) lowers and compiles each cell
over 512 placeholder host devices. The port's counterpart of those
placeholders is the meta device: tensors with shapes and dtypes and no
memory. It computes nothing, so this entry point's default of meta is no
quiet CPU run. Per cell:

  1. the production mesh (16x16 single-pod or 2x16x16 multi-pod;
     ``launch/mesh.py``) and every argument's placement on it from the
     logical-axis rules (``launch/specs.py``);
  2. per-device argument bytes (params, optimizer state, cache and inputs,
     each at its shard's size) and output bytes, and whether they fit the
     card's 80 GB (``fits``). Activations and temporaries are not counted:
     there is no compiler to schedule them;
  3. the step run once on meta tensors under ``analysis.cost.CostMode``
     (one microbatch counted m times, the update once) inside
     ``nn.mesh_context``, which records the activations' placements;
  4. the roofline terms at the card's peaks (``analysis/roofline.py``).
     The count is global (one process runs the whole step); the terms are
     per device: the FLOPs over the mesh's size, the bytes that split but
     at least the device's own arguments and outputs at their placements
     (a weight replicated over "data" is read whole on every device).
     Collective bytes come
     from XLA's SPMD partitioner in the reference and the port has none:
     ``wire_bytes`` is null, and the bottleneck is the larger of the
     compute and memory terms.

One JSON artifact a run goes to ``experiments/dryrun_torch/``. Runs are
resumable (an artifact that exists is skipped unless --force); the tool
keeps going after a failed cell and exits 1 if any failed.

Importing this module touches no device and no environment.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
WIRE_REASON = ("one process has no SPMD partitioner: the collectives a "
               "sharded step would run are not known")


def _flat(tree, prefix: str = ""):
    """(path, leaf) pairs of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _pattern(path: str) -> str:
    return "/".join("*" if p.isdigit() else p for p in path.split("/"))


def placements_summary(tree) -> dict:
    """Each leaf path (layer indices as ``*``) -> its distinct placements."""
    out: dict[str, list] = {}
    for path, p in _flat(tree):
        seen = out.setdefault(_pattern(path), [])
        if p.to_json() not in seen:
            seen.append(p.to_json())
    return out


def shard_bytes(tensors, placements) -> int:
    """Per-device bytes of a tree of tensors at their placements."""
    from repro_torch.models import nn

    return sum(p.shard_bytes(t) for t, p in zip(nn.tree_leaves(tensors),
                                                 nn.tree_leaves(placements)))


def run_step(cfg, shape, mesh, *, num_microbatches: int | None = None):
    """Build and run the cell's step once on meta tensors under a
    count inside ``mesh_context``. Returns (cost, memory, meta, scope)."""
    from repro_torch.analysis import cost as costmod
    from repro_torch.launch import specs as sp
    from repro_torch.models import nn
    from repro_torch.models.steps import (default_microbatches,
                                          make_decode_step, make_prefill_step,
                                          make_train_step, model_specs)

    B, S = shape.global_batch, shape.seq_len
    meta: dict = {}
    if shape.kind == "train":
        m = num_microbatches or default_microbatches(cfg, shape)
        state, batch = sp.state_specs(cfg), sp.train_batch_specs(cfg, shape)
        state_sh = sp.state_shardings(cfg, mesh)
        args = {"params": shard_bytes(state["params"], state_sh["params"]),
                "opt_state": shard_bytes(state["opt"], state_sh["opt"]),
                "inputs": shard_bytes(batch, sp.batch_shardings(batch, mesh))}
        step = make_train_step(cfg, num_microbatches=m)
        call = lambda: step(state, batch)                      # noqa: E731
        meta["num_microbatches"] = m
    else:
        specs = model_specs(cfg)
        params = nn.abstract_params(specs)
        cache_sh = sp.cache_shardings(cfg, mesh, B, S)
        args = {"params": shard_bytes(params,
                                      nn.param_shardings(specs, mesh))}
        if shape.kind == "prefill":
            inputs = sp.prefill_input_specs(cfg, shape)
            args["inputs"] = shard_bytes(inputs,
                                         sp.batch_shardings(inputs, mesh))
            step = make_prefill_step(cfg, batch=B, max_len=S,
                                     enc_len=S if cfg.encdec else 0)
            call = lambda: step(params, inputs)                # noqa: E731
        else:
            d = sp.decode_input_specs(cfg, shape)
            tokens = {"tokens": d["tokens"]}
            args["cache"] = shard_bytes(d["cache"], cache_sh)
            args["inputs"] = (shard_bytes(tokens,
                                          sp.batch_shardings(tokens, mesh))
                              + d["cache_index"].element_size())
            # the last slot: every cached position is attended (a full
            # cache), the most work a decode step of this cell does
            meta["cache_index"] = S - 1
            step = make_decode_step(cfg)
            call = lambda: step(params, d["cache"], tokens,   # noqa: E731
                                S - 1)
    t0 = time.perf_counter()
    with nn.mesh_context(mesh) as scope, costmod.CostMode() as mode:
        out = call()
    meta["count_s"] = time.perf_counter() - t0

    if shape.kind == "train":
        state_out, metrics = out
        outputs = {"state": args["params"] + args["opt_state"],
                   "metrics": sum(t.element_size() for t in metrics.values())}
        aliased = outputs["state"]          # updated in place
    else:
        logits, cache = out
        lp = sp.batch_shardings({"logits": logits}, mesh)["logits"]
        outputs = {"logits": lp.shard_bytes(logits),
                   "cache": shard_bytes(cache, cache_sh)}
        aliased = outputs["cache"] if shape.kind == "decode" else 0
    arg_b = sum(args.values())
    out_b = sum(outputs.values())
    memory = {"arguments_per_device": args,
              "argument_bytes_per_device": arg_b,
              "outputs_per_device": outputs,
              "output_bytes_per_device": out_b,
              "aliased_output_bytes_per_device": aliased,
              "bytes_per_device": arg_b + out_b - aliased,
              "temp_bytes": None,
              "note": "arguments and outputs at their shards' sizes; an "
                      "output updated in place is counted once; "
                      "activations and temporaries are not counted"}
    return mode.cost, memory, meta, scope


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, force=False,
             out_dir: Path = OUT_DIR, tag: str = "", opts=None,
             card: str | None = None) -> dict:
    """Size one cell and write its artifact (read back if it exists and
    ``force`` is off). ``opts``: ``smoke`` (the arch's smoke config),
    ``cfg_override`` (fields to replace), ``shape`` (a ``ShapeConfig`` in
    place of the named one), ``num_microbatches``."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import nn
    from repro_torch.models.steps import model_specs

    opts = opts or {}
    out_dir = Path(out_dir)
    name = f"{arch}__{shape_name}__{mesh_kind}" + (f"__{tag}" if tag else "")
    out_path = out_dir / f"{name}.json"
    if out_path.exists() and not force:
        print(f"skip (exists): {name}")
        return json.loads(out_path.read_text())
    card = card or rl.DEFAULT_CARD
    peaks = rl.peaks(card)
    cfg = get_config(arch, smoke=bool(opts.get("smoke")))
    if opts.get("cfg_override"):
        cfg = dataclasses.replace(cfg, **opts["cfg_override"])
    shape = opts.get("shape") or SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                device="meta")
    print(f"=== {name}: counting on the meta device...", flush=True)
    t0 = time.perf_counter()
    cost, memory, meta, scope = run_step(
        cfg, shape, mesh, num_microbatches=opts.get("num_microbatches"))
    memory["hbm_bytes"] = peaks.hbm_bytes
    memory["fits"] = memory["bytes_per_device"] <= peaks.hbm_bytes
    per_dev = cost.scaled(1.0 / mesh.size)
    # a device reads its arguments and writes its outputs at least once, at
    # their placements' shard sizes: a replicated weight is read in full on
    # every device, where the global count over the mesh's size splits it
    floor = (memory["argument_bytes_per_device"]
             + memory["output_bytes_per_device"])
    split_bytes = per_dev.hbm_bytes
    per_dev.hbm_bytes = max(split_bytes, floor)
    mf = rl.model_flops_step(cfg, shape)
    roof = rl.analyze(per_dev, model_flops=mf / mesh.size, card=card)
    if shape.kind == "train":
        placed = sp.state_shardings(cfg, mesh)
    else:
        placed = {"params": nn.param_shardings(model_specs(cfg), mesh),
                  "cache": sp.cache_shardings(cfg, mesh, shape.global_batch,
                                              shape.seq_len)}
    record = {
        "cell": name, "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": mesh.shape, "device": "meta", "card": peaks.name,
        **meta,
        "placements": {k: placements_summary(v) for k, v in placed.items()},
        "memory": memory,
        "cost": {
            "scope": "global: one process counts the whole step; the "
                     "per-device FLOPs are the global ones over the mesh's "
                     "size, the per-device bytes the larger of that split "
                     "and the device's own arguments and outputs at their "
                     "shard sizes",
            "flops_global": cost.flops,
            "hbm_bytes_global": cost.hbm_bytes,
            "flops_per_device": per_dev.flops,
            "hbm_bytes_per_device": per_dev.hbm_bytes,
            "hbm_bytes_per_device_split": split_bytes,
            "hbm_bytes_per_device_floor": floor,
            "flops_by_dtype_global": dict(cost.flops_by_dtype),
            "top_ops_by_bytes": cost.top(8, "bytes"),
            "top_ops_by_flops": cost.top(8, "flops"),
        },
        "model_flops_global": mf,
        "roofline": roof.to_dict(),
        "wire_bytes": None,
        "wire_bytes_reason": WIRE_REASON,
        "activation_placements": [
            {"axes": list(axes), "shape": list(shp),
             "placement": [list(a) if isinstance(a, tuple) else a
                           for a in spec], "calls": calls}
            for (axes, shp), (spec, calls) in scope.constraints.items()],
        "wall_s": time.perf_counter() - t0,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1, default=float))
    print(f"    ok: {record['wall_s']:.1f} s  bytes/dev "
          f"{memory['bytes_per_device'] / 1e9:.2f} GB "
          f"(fits {memory['fits']})  flops {cost.flops:.3e} global  "
          f"model {mf:.3e}  compute {roof.compute_term:.4g} s  memory "
          f"{roof.memory_term:.4g} s  bottleneck {roof.bottleneck}",
          flush=True)
    return record


def table(records: list[dict]) -> list[str]:
    """Markdown rows, one an (arch, shape), the meshes side by side: GB a
    device and whether it fits, counted and model FLOPs (global), and each
    mesh's bottleneck."""
    by_cell: dict = {}
    for r in records:
        by_cell.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    rows = ["| arch | shape | GB a device (pod / multipod) | fits | counted "
            "FLOPs | model FLOPs | bottleneck (pod / multipod) |",
            "|---|---|---|---|---|---|---|"]
    for (arch, shape), runs in by_cell.items():
        meshes = [runs[k] for k in ("pod", "multipod") if k in runs]
        gb = " / ".join(f"{r['memory']['bytes_per_device'] / 1e9:.2f}"
                        for r in meshes)
        fits = all(r["memory"]["fits"] for r in meshes)
        neck = " / ".join(r["roofline"]["bottleneck"] for r in meshes)
        rows.append(f"| {arch} | {shape} | {gb} | {'yes' if fits else 'NO'} "
                    f"| {meshes[0]['cost']['flops_global']:.4e} "
                    f"| {meshes[0]['model_flops_global']:.4e} | {neck} |")
    return rows


def work_list(args) -> list[tuple[str, str, str]]:
    from repro_torch.configs import ASSIGNED, cells

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        return [(a, s, mk) for a in ASSIGNED for s in cells(a)
                for mk in meshes]
    if not args.arch:
        raise SystemExit("--arch required unless --all")
    shapes = [args.shape] if args.shape else cells(args.arch)
    return [(args.arch, s, mk) for s in shapes for mk in meshes]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", type=Path, default=OUT_DIR)
    args = ap.parse_args(argv)

    work = work_list(args)
    failures, records = [], []
    for arch, shape, mk in work:
        try:
            records.append(run_cell(arch, shape, mk, force=args.force,
                                    out_dir=args.out_dir))
        except Exception as e:  # noqa: BLE001 - report and continue the matrix
            failures.append((arch, shape, mk, repr(e)))
            print(f"FAIL {arch} {shape} {mk}: {e}")
            traceback.print_exc()
    print("\n".join([""] + table(records)))
    slowest = max((r["wall_s"] for r in records), default=0.0)
    print(f"\n{len(work) - len(failures)}/{len(work)} cells OK; the slowest "
          f"took {slowest:.1f} s")
    for f in failures:
        print("FAILED:", *f[:3], f[3][:200])
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

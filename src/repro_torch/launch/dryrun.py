"""Dry run: trace every (architecture x input shape) on the meta device,
count its loop-aware roofline terms and its peak memory, and say whether
it fits one card (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --nodes 16 \\
        --out dryrun.json

Nothing is allocated and no device but meta is touched: the steps run on
meta tensors under :func:`repro_torch.launch.op_analysis.analyze_step`,
the hand-written kernels through their wrappers' meta paths. ``--nodes``
(default 16, the gossip nodes of the reference's single-pod mesh) takes
the place of the reference's ``--mesh``: the port runs on one card. Rows
append to a JSON list so long sweeps resume; an ``ok`` row carries
``peak_bytes`` and ``fits`` (the peak within the card's 80 GB) and
``trace_s`` in place of XLA's ``lower_s`` / ``compile_s``.

``--model-shards M`` (default 1, the rows above) splits each row's model
over M ranks of the "model" dim (:mod:`repro_torch.models.parallel`) and
counts one rank: its FLOPs, bytes, peak, ``fits`` and the collectives
its model axis charges on meta, the backward's among them. ``--data-shards
D`` (default 1) splits the data dim too: a train row's N node rows (a
rank holds N / D, the gossip's all-gathers and node reductions charged),
a serve row's batch, or, for a decode of global batch 1 (long_500k), each
KV cache's slots (the reference's ``shard_seq``: the batch and the
recurrent states whole on the rank, each attention's data ranks merged by
a MAX and a SUM all-reduce). ``--mesh pod16x16`` / ``pod2x16x16`` are the
reference's production meshes (``repro/launch/mesh.py``): data 16 (32
over data x pod, the node count too) and model 16. A row's model rank is
the busiest (the most query heads, then KV heads: M need not divide H,
:meth:`~repro_torch.models.parallel.ModelAxis.span`), named in the row
(``model_rank``, ``heads``, ``kv_heads``), its data rank 0 (``mesh`` is
``model<M>`` / ``data<D>+model<M>`` for a serve row,
``nodes<N>+model<M>`` / ``nodes<N>+data<D>+model<M>`` for a train row,
or the production mesh's name). Every group kind splits; the mLSTM's
gather of ``u`` is an all-reduce into a zero-filled buffer (as the
vocabulary gather is), so it counts under "all-reduce" in
``coll_calls``, as the c10d calls do. A row whose model M does not split
(a leaf dim of the reference's "model" pspecs that M does not divide) is
skipped with the reason.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.launch.op_analysis import HW
from repro_torch.launch.steps import build_serve_plan, build_train_plan
from repro_torch.models.parallel import ModelAxis

SKIP_REASON = ("full-attention arch; long_500k needs sub-quadratic "
               "attention (DESIGN.md)")


def _variant(schedule: str, param_dtype: str | None, two_pass: bool | None,
             cache_dtype: str | None) -> str:
    """The row's variant key: the reference's, less ``carrycache``, which
    changes nothing the port runs (``--carry-cache``)."""
    return "+".join(
        [schedule]
        + ([param_dtype] if param_dtype else [])
        + (["onepass"] if two_pass is False else [])
        + ([f"cache-{cache_dtype}"] if cache_dtype else []))


# the reference's production meshes: (data shards, model shards, nodes)
MESHES = {"pod16x16": (16, 16, 16), "pod2x16x16": (32, 16, 32)}


def _mesh_name(kind: str, nodes: int, model_shards: int,
               data_shards: int = 1) -> str:
    if model_shards == 1 and data_shards == 1:
        return f"nodes{nodes}"
    parts = ([f"nodes{nodes}"] if kind == "train" else []) \
        + ([f"data{data_shards}"] if data_shards > 1 else []) \
        + [f"model{model_shards}"]
    return "+".join(parts)


def busiest_rank(cfg, model_shards: int) -> tuple[int, int, int]:
    """(rank, query heads, KV heads) of the model rank holding the most
    query heads, then KV heads (the first of them)."""
    axis = [ModelAxis(size=model_shards, rank=r) for r in range(model_shards)]
    load = [(a.span(cfg.n_heads), a.kv_heads(cfg.n_heads, cfg.n_kv_heads))
            for a in axis]
    size = [(q.stop - q.start, k.stop - k.start) for q, k in load]
    r = size.index(max(size))
    return r, *size[r]


def run_one(arch_name: str, shape_name: str, *, nodes: int = 16,
            schedule: str = "dense", param_dtype: str | None = None,
            two_pass: bool | None = None, cache_dtype: str | None = None,
            carry_cache: bool = False, model_shards: int = 1,
            data_shards: int = 1, mesh: str | None = None,
            verbose: bool = True) -> dict:
    """One row; ``mesh`` (a name of :data:`MESHES`) sets ``data_shards``,
    ``model_shards`` and ``nodes``."""
    if mesh is not None:
        data_shards, model_shards, nodes = MESHES[mesh]
    arch = get_config(arch_name)
    shape = INPUT_SHAPES[shape_name]
    sharded = model_shards > 1 or data_shards > 1
    mesh_name = mesh or _mesh_name(shape.kind, nodes, model_shards,
                                   data_shards)
    if not arch.runs_shape(shape_name):
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIP_REASON}
    if sharded:
        try:
            ModelAxis(size=model_shards).check(arch.model)
        except (ValueError, NotImplementedError) as e:
            return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                    "status": "skipped",
                    "reason": f"{type(e).__name__}: {e}"}
    rank, heads, kv_heads = busiest_rank(arch.model, model_shards)
    variant = _variant(schedule, param_dtype, two_pass, cache_dtype)
    t0 = time.time()
    try:
        if shape.kind == "train":
            plan = build_train_plan(arch, nodes, shape_name=shape_name,
                                    schedule=schedule,
                                    param_dtype=param_dtype,
                                    two_pass=two_pass,
                                    model_shards=model_shards,
                                    model_rank=rank, data_shards=data_shards)
        else:
            axis = ModelAxis(size=model_shards, rank=rank,
                             data_size=data_shards) if sharded else None
            plan = build_serve_plan(arch, axis, shape_name=shape_name,
                                    param_dtype=param_dtype,
                                    cache_dtype=cache_dtype,
                                    carry_cache=carry_cache)
        terms = plan.cost()
        trace_s = time.time() - t0
        row = terms.row()
        row.update({
            "mesh": mesh_name, "status": "ok", "schedule": variant,
            "trace_s": round(trace_s, 1),
            "peak_bytes": terms.peak_memory_bytes,
            "fits": terms.peak_memory_bytes <= HW.memory_bytes,
        })
        if sharded:
            row.update({"model_shards": model_shards,
                        "data_shards": data_shards, "model_rank": rank,
                        "heads": heads, "kv_heads": kv_heads,
                        "coll_calls": dict(terms.coll_calls)})
            if shape.kind != "train":
                row["seq_sharded"] = plan.model.axis.seq_split
            if data_shards == 1:
                row["nodes_whole" if shape.kind == "train"
                    else "batch_whole"] = True
        if verbose:
            print(f"[{arch_name} x {shape_name} x {mesh_name} x {variant}] OK "
                  f"trace={trace_s:.1f}s")
            print(f"  flops={terms.flops:.3e} (aten {terms.aten_flops:.3e}, "
                  f"kernels {terms.kernel_flops:.3e}) "
                  f"bytes={terms.bytes_accessed:.3e} "
                  f"peak={terms.peak_memory_bytes / 1e9:.2f} GB "
                  f"fits={row['fits']}")
            print(f"  roofline: compute={terms.t_compute*1e3:.2f}ms "
                  f"memory={terms.t_memory*1e3:.2f}ms "
                  f"collective={terms.t_collective*1e3:.2f}ms "
                  f"-> {terms.bottleneck}-bound  "
                  f"useful_flops={terms.useful_flops_ratio:.2f}")
        return row
    except Exception as e:  # a failure here is a port bug — surface it
        if verbose:
            traceback.print_exc()
        return {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
                "schedule": variant, "status": "error",
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--nodes", type=int, default=16,
                    help="gossip nodes of the training step (the reference's "
                         "--mesh pod1 has 16)")
    ap.add_argument("--schedule", choices=("dense", "circulant"), default="dense")
    ap.add_argument("--param-dtype", choices=("float32", "bfloat16"), default=None)
    ap.add_argument("--single-pass", action="store_true",
                    help="fused single-gradient-pass PartPSP variant")
    ap.add_argument("--cache-dtype", choices=("float32", "bfloat16"), default=None)
    ap.add_argument("--carry-cache", action="store_true",
                    help="the reference's decode_cache_in_carry path; a no-op "
                         "here (the port's decode always writes its cache in "
                         "place, that path's layout), left out of the row's "
                         "variant")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="one rank of a model split over this many ranks "
                         "of the mesh's 'model' dim (the data dim 1: a "
                         "serve row's batch, a train row's nodes whole on "
                         "the rank)")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="one rank of the mesh's 'data' dim of this many "
                         "ranks: a train row's node rows, a serve row's "
                         "batch, a long_500k decode's KV slots")
    ap.add_argument("--mesh", choices=tuple(MESHES), default=None,
                    help="the reference's production mesh: pod16x16 (data "
                         "16, model 16, 16 nodes) or pod2x16x16 (data x pod "
                         "32, model 16, 32 nodes); sets --nodes, "
                         "--data-shards and --model-shards")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape)")
    ap.add_argument("--out", default=None, help="append JSON rows to this file")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if (args.all or not args.shape) else (args.shape,)
    two_pass = False if args.single_pass else None
    variant = _variant(args.schedule, args.param_dtype, two_pass,
                       args.cache_dtype)

    rows = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("schedule", "dense"))
            for r in rows if r.get("status") == "ok"}

    t_all = time.time()
    for arch_name in archs:
        for shape_name in shapes:
            mesh_name = args.mesh or _mesh_name(
                INPUT_SHAPES[shape_name].kind, args.nodes, args.model_shards,
                args.data_shards)
            key = (arch_name, shape_name, mesh_name, variant)
            if key in done:
                print(f"[{arch_name} x {shape_name} x {mesh_name}] cached")
                continue
            row = run_one(arch_name, shape_name, nodes=args.nodes,
                          schedule=args.schedule,
                          param_dtype=args.param_dtype, two_pass=two_pass,
                          cache_dtype=args.cache_dtype,
                          carry_cache=args.carry_cache,
                          model_shards=args.model_shards,
                          data_shards=args.data_shards, mesh=args.mesh)
            rows = [r for r in rows
                    if (r["arch"], r["shape"], r["mesh"],
                        r.get("schedule", "dense")) != key]
            rows.append(row)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(rows, f, indent=1, default=str)

    n_ok = sum(1 for r in rows if r.get("status") == "ok")
    n_skip = sum(1 for r in rows if r.get("status") == "skipped")
    n_err = sum(1 for r in rows if r.get("status") == "error")
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    print(f"dry-run wall time: {time.time() - t_all:.1f} s")
    if n_err:
        for r in rows:
            if r.get("status") == "error":
                print(f"  ERROR {r['arch']} x {r['shape']} x {r['mesh']}: {r['error']}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()

"""Dry run: trace every (architecture × input shape) cell on the production
meshes with ``meta`` tensors and write its cost and memory record — the
port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells, both meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --reduced      # the tiny configs
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch fm --shape train_batch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod    # 2×16×16 only
    PYTHONPATH=src python -m repro_torch.launch.dryrun --jobs 6       # six cells at a time

The reference lowers and compiles each cell for 256 or 512 placeholder
devices and reads XLA's cost and memory analysis. Here the mesh is a
:class:`~repro_torch.parallel.compat.StackedMesh` of the production shape
on the ``meta`` device (:func:`~repro_torch.launch.mesh.make_production_mesh`),
and ``cell.fn(*cell.args)`` runs once on the cell's meta tensors: every
operation computes its output's shape and dtype and nothing else, on the
CPU or beside the card alike. Three counters watch the trace:

* ``torch.utils.flop_counter.FlopCounterMode``: the matmuls' and
  convolutions' FLOPs (elementwise work is not counted, as XLA's
  ``flops`` counts it only in part);
* the hand kernels' own records (:func:`repro_torch.kernels.backend.record_costs`):
  a wrapper on meta tensors returns its outputs by its shape rule and adds
  its operations and bytes, counted as its bound counts them;
* :class:`CostMode`, a ``TorchDispatchMode``: each operation's input and
  output bytes (unfused, so an upper bound on the traffic; views move
  nothing) and the live bytes of the storages the trace allocates, whose
  peak is ``temp_bytes``.

The record has the reference's keys. ``argument_bytes`` is exact: each
argument leaf's block on one device under its spec, a dimension that does
not split evenly taking the ceiling (as GSPMD pads it). ``output_bytes``
places each output as the argument of its structure (the train state, a
decode's cache), else each leaf as the argument leaf of its shape and
dtype, else its first dimension of the batch's size over the batch's
axes, else replicated. FLOPs, bytes accessed and
temporaries are the global trace's divided by the mesh's devices: an even
split, which the record's ``note`` says; a train cell's note adds that the
port's own sharded step does not split so (its ranks along ``model``
repeat the compute, and each holds the gathered parameters and the whole
gradient). ``collectives`` are, for a train
cell, what the port's sharded step
(:func:`repro_torch.train.steps.make_sharded_train_step`) moves for those
specs (:func:`~repro_torch.train.steps.sharded_step_collectives`: the
step's own gather and reduction, run on meta blocks); for a cell that runs a
``shard_map`` body (expert-parallel MoE, the mesh search), what its
collectives move on a rank mesh of that shape — among these the recsys
``serve`` and ``retrieval`` cells, whose ``build(mesh)`` gives the
sharded function (:func:`repro_torch.models.recsys.sharded_cell_fn`:
tables row-sharded over ``model``, the ranks along ``model`` repeating
the towers and encoders, which the note says), and the dense LMs'
``prefill`` and ``decode`` cells, whose ``build(mesh)`` gives theirs
(:func:`repro_torch.models.transformer.sharded_cell_fn`: tensor-parallel
prefill, sequence-sharded decode merged by K5's log-sum-exp; the note says
what the ranks along ``model`` repeat); otherwise ``null``: the port has
no sharded implementation of that cell (on the production meshes none is
left; the reduced MoE LMs' serving cells, which route their experts
without EP, are). A meta mesh traces a
sharded function's dimension that does not split evenly at its padded
block; the note says so where an argument does not split (a run on values
refuses it).

Records go to ``build/dryrun/<mesh>/<arch>__<shape>.json`` at the
repository root unless ``--out`` says otherwise; an existing ok or skip
record is kept unless ``--force``. The exit code is 1 when a cell failed.
No JAX flag is set and no device is touched: the trace needs none.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import all_cells, build_cells
from repro_torch.kernels import backend
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import compat
from repro_torch.parallel.compat import P
from repro_torch.parallel.sharding import spec_leaves

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = (("pod1_16x16", False), ("pod2_2x16x16", True))
EVEN_SPLIT = ("flops, bytes_accessed and temp_bytes are the global trace's divided "
              "evenly over the mesh's devices")
TRAIN_SPLIT = ("per_device is that ideal split, not the port's sharded step, which repeats "
               "the whole compute on the ranks along model and holds the gathered parameters "
               "and the whole gradient on every rank; collectives are that step's")
NO_SHARDED = "the port has no sharded implementation of this cell: collectives not counted"
MODEL_REPEATS = ("the port's sharded function repeats the dense towers and encoders on the "
                 "ranks along model (recsys_rules replicate mlp and heads)")
LM_REPEATS = ("flops, bytes and temporaries are the port's sharded function's: the ranks "
              "along model repeat the norms and the residual stream, a prefill shard attends "
              "the whole heads its wq columns touch (q gathered where they split a head), a "
              "decode shard attends all heads over its slice of the cache")
UNEVEN = ("an argument does not split evenly over its axes: traced at its padded block, as "
          "GSPMD pads it; a run on values refuses this split")
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _leaves(tree) -> list:
    """Tensor leaves of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tensors(tree) -> list:
    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Bytes each operation reads and writes, and the live bytes of the
    storages allocated inside the mode (their peak), over a meta trace."""

    def __init__(self):
        super().__init__()
        self.bytes_accessed = 0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: set[int] = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        if func.is_view:                 # a view moves nothing and allocates nothing
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func.overloadpacket.__name__ not in _NO_TRAFFIC:
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        read = {t.untyped_storage()._cdata for t in ins}
        for t in outs:                   # an in-place or out= result is no new storage
            if t.untyped_storage()._cdata not in read:
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = storage.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n


def local_bytes(t: torch.Tensor, spec, mesh) -> int:
    """One device's block of ``t`` placed by ``spec``: each dimension split
    over its axes, rounded up where it does not split evenly."""
    return math.prod(mesh.block_shape(t.shape, spec, pad=True)) * t.element_size()


def _uneven(args, specs, mesh) -> bool:
    """Whether an argument leaf does not split evenly under its spec."""
    for t, s in zip(_leaves(args), spec_leaves(specs)):
        if isinstance(t, torch.Tensor):
            try:
                mesh.block_shape(t.shape, s)
            except ValueError:
                return True
    return False


def argument_bytes(args, specs, mesh) -> int:
    return sum(local_bytes(t, s, mesh) for t, s in zip(_leaves(args), spec_leaves(specs))
               if isinstance(t, torch.Tensor))


def output_bytes(out, args, specs, mesh) -> int:
    """Each output placed as the argument of its structure (leaf for leaf:
    a train step's new state, a decode's cache), else each leaf as the
    argument leaf of its shape and dtype, else its first dimension of the
    batch's size over the batch's axes, else replicated."""
    arg_parts = [(_tensors(a), spec_leaves(s)) for a, s in zip(args, specs)]
    like, batch = {}, {}
    for t, s in zip(_leaves(args), spec_leaves(specs)):
        if not isinstance(t, torch.Tensor):
            continue
        like.setdefault((tuple(t.shape), t.dtype), s)
        if t.dim() and len(s) and set(mesh.axes(s[0])) & {"data", "pod"} and t.shape[0] > 1:
            batch.setdefault(t.shape[0], s[0])

    def key(ts):
        return [(tuple(t.shape), t.dtype) for t in ts]

    total = 0
    for part in (out if isinstance(out, tuple) else (out,)):
        leaves = _tensors(part)
        same = [s for ts, s in arg_parts if key(ts) == key(leaves)]
        if same:
            total += sum(local_bytes(t, s, mesh) for t, s in zip(leaves, same[0]))
            continue
        for t in leaves:
            spec = like.get((tuple(t.shape), t.dtype))
            if spec is None:
                spec = P()
                for d, size in enumerate(t.shape):
                    if size in batch:
                        spec = P(*([None] * d), batch[size])
                        break
            total += local_bytes(t, spec, mesh)
    return total


def trace(cell, mesh) -> dict:
    """Run one cell on meta tensors under ``mesh``; its output, the
    counters' totals, and the step's collectives."""
    if hasattr(cell, "build"):                 # late-bound (anlessini)
        fn, args, specs = cell.build(mesh)
    else:
        fn, args, specs = cell.fn, cell.args, cell.in_specs
    flop_counter = FlopCounterMode(display=False)
    cost = CostMode()
    with compat.use_mesh(mesh), compat.count_collectives() as coll, \
            backend.record_costs() as kernels, flop_counter, cost:
        out = fn(*args)
    collectives = coll.record() if coll.counts else None
    if cell.kind == "train":
        from repro_torch.train.steps import STEP_METRICS, sharded_step_collectives
        state_specs, batch_specs = specs
        collectives = sharded_step_collectives(
            args[0], state_specs, batch_specs, mesh,
            n_metrics=len(out[1]) - len(STEP_METRICS))
    return {"out": out, "args": args, "specs": specs,
            "flops": flop_counter.get_total_flops() + sum(k.flops for k in kernels),
            "bytes_accessed": cost.bytes_accessed + sum(k.bytes for k in kernels),
            "peak_new": cost.peak, "ops": cost.ops, "collectives": collectives,
            "kernels": kernels}


def run_cell(name: str, cell, mesh, mesh_name: str, out_dir, *, force: bool = False,
             verbose: bool = True) -> dict:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / (name.replace("/", "__") + ".json")
    if path.exists() and not force:
        rec = json.loads(path.read_text())
        if rec.get("ok") or rec.get("skip"):
            if verbose:
                print(f"[cache] {describe(rec)}", flush=True)
            return rec

    if cell.skip:
        rec = {"cell": name, "mesh": mesh_name, "skip": True, "note": cell.note}
        path.write_text(json.dumps(rec, indent=1))
        if verbose:
            print(describe(rec), flush=True)
        return rec

    t0 = time.perf_counter()
    try:
        r = trace(cell, mesh)
        n = mesh.size
        arg_b = argument_bytes(r["args"], r["specs"], mesh)
        out_b = output_bytes(r["out"], r["args"], r["specs"], mesh)
        temp_b = -(-r["peak_new"] // n)
        kernel_calls: dict[str, int] = {}
        for k in r["kernels"]:
            kernel_calls[k.name] = kernel_calls.get(k.name, 0) + 1
        notes = [EVEN_SPLIT]
        if cell.kind == "train":
            notes.append(TRAIN_SPLIT)
        if cell.kind in ("serve", "retrieval") and cell.fn is not None and hasattr(cell, "build"):
            notes.append(MODEL_REPEATS)
        if cell.kind in ("prefill", "decode") and hasattr(cell, "build"):
            notes.append(LM_REPEATS)
        if r["collectives"] is None:
            notes.append(NO_SHARDED)
        if hasattr(cell, "build") and _uneven(r["args"], r["specs"], mesh):
            notes.append(UNEVEN)
        rec = {
            "cell": name, "mesh": mesh_name, "ok": True,
            "kind": cell.kind,
            "compile_s": round(time.perf_counter() - t0, 2),
            "per_device": {
                "flops": float(r["flops"]) / n,
                "bytes_accessed": float(r["bytes_accessed"]) / n,
                "argument_bytes": int(arg_b),
                "output_bytes": int(out_b),
                "temp_bytes": int(temp_b),
                "peak_bytes": int(arg_b + temp_b),
            },
            "collectives": r["collectives"],
            "global": {
                "flops": float(r["flops"]),
                "argument_bytes": int(sum(_nbytes(t) for t in _tensors(r["args"]))),
                "output_bytes": int(sum(_nbytes(t) for t in _tensors(r["out"]))),
                "peak_bytes": int(r["peak_new"]),
                "ops": r["ops"],
                "kernel_calls": kernel_calls,
            },
            "devices": n,
            "note": "; ".join(notes),
        }
    except Exception as e:        # one cell's failure is its record; the run goes on
        rec = {"cell": name, "mesh": mesh_name, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc(limit=6),
               "compile_s": round(time.perf_counter() - t0, 2)}
    if verbose:
        print(describe(rec), flush=True)
    path.write_text(json.dumps(rec, indent=1))
    return rec


def describe(rec: dict) -> str:
    """One line of a record, as the run prints it."""
    where = f"{rec['mesh']} {rec['cell']}"
    if rec.get("skip"):
        return f"[skip ] {where}: {rec['note'][:80]}"
    if not rec.get("ok"):
        return f"[FAIL ] {where}: {rec['error'][:160]}\n{rec.get('traceback', '')}"
    pd = rec["per_device"]
    coll = rec["collectives"]["total_bytes"] if rec["collectives"] else None
    return (f"[ok   ] {where}: flops/dev={pd['flops']:.3g} "
            f"bytes/dev={pd['bytes_accessed']:.3g} peak={pd['peak_bytes'] / 2**30:.2f}GiB "
            f"args={pd['argument_bytes']:.3g}B "
            f"coll={'null' if coll is None else f'{coll:.3g}B'} ({rec['compile_s']}s)")


def select_cells(*, arch=None, shape=None, multi_pod: bool, reduced: bool) -> dict:
    if arch:
        cells = {f"{arch}/{k}": v for k, v in build_cells(
            arch, multi_pod=multi_pod, reduced=reduced).items()}
    else:
        cells = all_cells(multi_pod=multi_pod, reduced=reduced)
    if shape:
        cells = {k: v for k, v in cells.items() if k.endswith("/" + shape)}
    return cells


def _run_one(job: tuple) -> dict:
    """One (mesh, cell) in a worker process: the cell built there anew."""
    mesh_name, multi_pod, name, reduced, out_dir, force = job
    arch, shape = name.split("/")
    cell = build_cells(arch, multi_pod=multi_pod, reduced=reduced)[shape]
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    return run_cell(name, cell, mesh, mesh_name, out_dir, force=force, verbose=False)


def run_iter(*, arch=None, shape=None, meshes=MESHES, reduced: bool = False, out=None,
             force: bool = False, jobs: int = 1):
    """Every selected cell on every mesh of ``meshes`` (started mesh by
    mesh): each record as it is written. ``jobs`` > 1 traces that many
    cells at a time, each in a spawned worker process (a trace is Python
    work on one core), and yields the records in the order they finish."""
    base_out = Path(out) if out else RESULTS_DIR
    todo = [(mesh_name, multi_pod, name, reduced, str(base_out / mesh_name), force)
            for mesh_name, multi_pod in meshes
            for name in select_cells(arch=arch, shape=shape, multi_pod=multi_pod,
                                     reduced=reduced)]
    if jobs <= 1:
        yield from map(_run_one, todo)
        return
    with multiprocessing.get_context("spawn").Pool(jobs) as pool:
        yield from pool.imap_unordered(_run_one, todo, chunksize=1)


def run(**kw) -> list[dict]:
    """:func:`run_iter`'s records, each printed as it comes."""
    records = []
    for rec in run_iter(**kw):
        print(describe(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Trace every cell on the production meshes "
                                             "with meta tensors")
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name")
    ap.add_argument("--multi-pod", action="store_true", help="only the 2×16×16 mesh")
    ap.add_argument("--single-pod", action="store_true", help="only the 16×16 mesh")
    ap.add_argument("--force", action="store_true", help="trace again over kept records")
    ap.add_argument("--reduced", action="store_true", help="debug: tiny configs")
    ap.add_argument("--out", default=None, help=f"records' root (default {RESULTS_DIR})")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at a time, each in a worker process")
    args = ap.parse_args(argv)

    meshes = [(name, mp) for name, mp in MESHES
              if not (mp and args.single_pod) and not (not mp and args.multi_pod)]
    records = run(arch=args.arch, shape=args.shape, meshes=meshes, reduced=args.reduced,
                  out=args.out, force=args.force, jobs=args.jobs)
    n_fail = sum(not (r.get("ok") or r.get("skip")) for r in records)
    print(f"\ndry-run complete; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

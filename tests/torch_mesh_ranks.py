"""Rank programs of the port's multi-rank mesh tests, and the seeded inputs
they share with ``tests/test_torch_mesh.py``.

    python tests/torch_mesh_ranks.py <case> <world> <workdir>

starts ``world`` gloo ranks with ``torch.multiprocessing.spawn``; they meet
through a ``FileStore`` under ``workdir`` (no TCP port), run ``<case>`` on a
:class:`repro_torch.parallel.compat.RankMesh`, and each writes its global
outputs to ``workdir/rank<r>.npz``. Imports no JAX: only ``repro_torch``.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch

MESH_DOCS = 256           # 8 partitions of 32
TIE = (37, 69)            # the same text in partitions 1 and 2


def mesh_corpus() -> list[tuple[str, str]]:
    """``synth_corpus(256)`` with doc 69 (partition 2) a copy of doc 37's
    text (partition 1): under global stats their scores are the same bits."""
    from repro_torch.data.corpus import synth_corpus
    docs = synth_corpus(MESH_DOCS, vocab=400, seed=3)
    a, b = TIE
    docs[b] = (docs[b][0], docs[a][1])
    return docs


def mesh_queries(docs) -> list[str]:
    """Ten ``synth_queries`` and one of the tied doc's own terms."""
    from repro_torch.data.corpus import synth_queries
    return synth_queries(docs, 10, seed=5) + [" ".join(docs[TIE[0]][1].split()[:4])]


SEARCH_CASES = [(acc, fused) for acc in ("dense", "pruned") for fused in (False, True)]


def search_outputs(mesh) -> dict:
    """Every (accumulator, gather) of the 8-partition search on ``mesh``."""
    from repro_torch.search.bm25 import encode_queries
    from repro_torch.search.distributed import build_partitioned_state, make_dist_search_fn
    docs = mesh_corpus()
    queries = mesh_queries(docs)
    out = {}
    for acc, fused in SEARCH_CASES:
        state, cfg, vocab = build_partitioned_state(
            docs, 8, {"k": 10, "max_blocks": 64, "accumulator": acc, "fused_gather": fused},
            device="cpu")
        tids, qtf = encode_queries(vocab, queries, max_terms=cfg.max_terms)
        s, i = make_dist_search_fn(cfg, ("data", "model"), mesh=mesh)(state, tids, qtf)
        out[f"{acc}_{int(fused)}_scores"] = s.cpu().numpy()
        out[f"{acc}_{int(fused)}_ids"] = i.cpu().numpy()
    return out


def lookup_inputs():
    rng = np.random.default_rng(11)
    table = rng.standard_normal((64, 5)).astype(np.float32)
    idx = rng.integers(0, 64, 12).astype(np.int32)
    return table, idx


def lookup_outputs(mesh) -> dict:
    from repro_torch.models.embedding import sharded_lookup_shardmap
    table, idx = lookup_inputs()
    return {"rows": sharded_lookup_shardmap(mesh, table, idx).cpu().numpy()}


def bert4rec_inputs():
    """bert4rec's reduced config with ``sharded_topk``, seeded parameters
    and 6 sequences."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.common import init_params
    from repro_torch.models.recsys import recsys_param_defs
    cfg = dataclasses.replace(get_arch("bert4rec").reduced_config(), sharded_topk=True)
    params = init_params(recsys_param_defs(cfg), torch.Generator().manual_seed(4), "cpu")
    seq = np.random.default_rng(5).integers(0, cfg.n_items, (6, cfg.seq_len)).astype(np.int32)
    return cfg, params, seq


def bert4rec_outputs(mesh) -> dict:
    from repro_torch.models.recsys import bert4rec_serve_topk
    from repro_torch.parallel import compat
    cfg, params, seq = bert4rec_inputs()
    with compat.use_mesh(mesh):
        v, i = bert4rec_serve_topk(params, seq, cfg, k=10, device="cpu")
    return {"vals": v.numpy(), "ids": i.numpy()}


def ep_moe_inputs():
    """``tests/test_distributed.py``'s expert-parallel case (MoE 8 experts
    top-2 + 1 shared, x (8, 4, 16)): parameters from a seeded
    ``torch.Generator``, x from numpy."""
    from repro_torch.models.common import init_params
    from repro_torch.models.moe import MoEConfig, moe_defs
    cfg = MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=8, n_shared=1, capacity_factor=8.0)
    params = init_params(moe_defs(cfg, torch.float32), torch.Generator().manual_seed(0), "cpu")
    x = np.random.default_rng(1).standard_normal((8, 4, 16)).astype(np.float32)
    return cfg, params, torch.from_numpy(x)


def ep_moe_outputs(mesh) -> dict:
    from repro_torch.models.moe_ep import ep_moe_ffn
    from repro_torch.parallel import compat
    cfg, params, x = ep_moe_inputs()
    with compat.use_mesh(mesh):
        y, aux = ep_moe_ffn(params, x, cfg)
    return {"y": y.numpy(), "aux": np.float32(aux)}


def numpy_params(defs, seed: int) -> list:
    """One array per ParamDef leaf (sorted key order), from numpy: ones,
    zeros, or normal draws scaled as ``init_params`` scales them."""
    from repro_torch.models.common import tree_leaves
    rng = np.random.default_rng(seed)
    out = []
    for d in tree_leaves(defs):
        if d.init in ("ones", "zeros"):
            out.append((np.ones if d.init == "ones" else np.zeros)(d.shape, np.float32))
            continue
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else (
            0.02 if d.init == "embed" else 1.0 / np.sqrt(fan_in))
        out.append((rng.standard_normal(d.shape) * scale).astype(np.float32))
    return out


SHARDED_TRAIN_STEPS = 2


def sharded_train_inputs():
    """``tests/test_distributed.py``'s sharded-step case: stablelm-3b's
    reduced config, lm_rules(fsdp=True), a batch of 8 × 16 tokens, AdamW at
    lr 1e-3 — with one warmup step, so that the first step already moves
    every parameter by about lr (the default 100 would move it by lr/100);
    parameters and tokens from numpy. Returns (cfg, defs, numpy parameter
    leaves, batch, rules, OptConfig)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import lm_param_defs
    from repro_torch.parallel.sharding import lm_rules
    from repro_torch.train.optim import OptConfig
    cfg = get_arch("stablelm-3b").reduced_config()
    defs = lm_param_defs(cfg)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)}
    return (cfg, defs, numpy_params(defs, 0), batch, lm_rules(fsdp=True),
            OptConfig(lr=1e-3, warmup_steps=1))


def train_state(defs, leaves, device="cpu"):
    """The port's initial train state from numpy parameter leaves."""
    from repro_torch.models.common import abstract_params
    from repro_torch.train.optim import unflatten
    from repro_torch.train.steps import init_train_state
    params = unflatten(abstract_params(defs), [
        torch.tensor(a, device=device, dtype=m.dtype)
        for a, m in zip(leaves, _leaves(abstract_params(defs)))])
    return init_train_state(params)


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return tree_leaves(tree)


def sharded_train_outputs(mesh) -> dict:
    """SHARDED_TRAIN_STEPS sharded train steps on ``mesh``: each step's
    loss and grad norm, every parameter leaf and first moment gathered
    back (``p<i>``, ``m<i>``), and what compat's collectives moved during
    the first step (the dry run's ``collectives`` entry, as JSON)."""
    import json

    from repro_torch.configs.cells import train_state_specs
    from repro_torch.models.transformer import lm_loss
    from repro_torch.parallel import compat
    from repro_torch.parallel.sharding import gather_tree, place_tree
    from repro_torch.train.steps import make_sharded_train_step
    cfg, defs, leaves, batch, rules, opt = sharded_train_inputs()
    sspecs = train_state_specs(defs, rules)
    bspecs = {"tokens": rules.batch_spec(None), "labels": rules.batch_spec(None)}
    step = make_sharded_train_step(lambda p, b: lm_loss(p, b, cfg), opt, mesh, sspecs, bspecs)
    state = place_tree(train_state(defs, leaves), sspecs, mesh)
    local = place_tree(batch, bspecs, mesh)
    losses, norms = [], []
    for i in range(SHARDED_TRAIN_STEPS):
        with compat.count_collectives() as log:
            state, metrics = step(state, local)
        if i == 0:
            moved = log.record()
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    full = gather_tree(state, sspecs, mesh)
    out = {"loss": np.float32(losses), "grad_norm": np.float32(norms),
           "collectives": np.array(json.dumps(moved, sort_keys=True))}
    for i, (p, m) in enumerate(zip(_leaves(full["params"]), _leaves(full["opt"]["m"]))):
        out[f"p{i}"], out[f"m{i}"] = p.float().numpy(), m.numpy()
    return out


SERVE_ARCHS = ("fm", "dcn-v2", "bst", "bert4rec")
SERVE_SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
SERVE_CELLS = [(arch, shape) for arch in SERVE_ARCHS for shape in SERVE_SHAPES]


def _nested(defs, leaves):
    """A tree of ``defs``' structure (sorted keys) over ``leaves`` in order."""
    it = iter(leaves)

    def build(d):
        return {k: build(d[k]) for k in sorted(d)} if isinstance(d, dict) else next(it)
    return build(defs)


def serve_inputs(arch: str, shape: str, *, multi_pod: bool = False, seed: int = 0):
    """A reduced recsys serve or retrieval cell and its seeded numpy inputs:
    ``(cell, cfg, args)``, ``args`` the cell's arguments as numpy trees —
    parameters as ``numpy_params`` draws them, ids over the whole table
    (fields' rows, items), dense features and candidates |normal × 0.05|."""
    from repro_torch.configs import build_cells, get_arch
    from repro_torch.models.recsys import recsys_param_defs
    cfg = get_arch(arch).reduced_config()
    cell = build_cells(arch, multi_pod=multi_pod, reduced=True)[shape]
    defs = recsys_param_defs(cfg)
    params = _nested(defs, numpy_params(defs, seed))
    rng = np.random.default_rng(seed + 1)
    high = {"sparse": cfg.rows_per_field, "seq": cfg.n_items, "target": cfg.n_items}
    batch = {}
    for key in sorted(cell.args[1]):
        t = cell.args[1][key]
        batch[key] = (rng.integers(0, high[key], tuple(t.shape)).astype(np.int32)
                      if key in high else
                      np.abs(rng.standard_normal(tuple(t.shape)) * 0.05).astype(np.float32))
    args = (params, batch)
    if cell.kind == "retrieval":
        args += (np.abs(rng.standard_normal(tuple(cell.args[2].shape)) * 0.05
                        ).astype(np.float32),)
    return cell, cfg, args


def serve_args_on(cfg, args, device="cpu") -> tuple:
    """``serve_inputs``' numpy arguments as the port's: the parameters
    through ``models/weights.py``, the rest as tensors."""
    from repro_torch.models.weights import recsys_params_from_numpy
    return (recsys_params_from_numpy(args[0], cfg, device=device),
            {k: torch.from_numpy(v).to(device) for k, v in args[1].items()},
            *(torch.from_numpy(a).to(device) for a in args[2:]))


def sharded_serve_outputs(mesh, cells=SERVE_CELLS) -> dict:
    """Each reduced recsys serve and retrieval cell's sharded function on
    ``mesh`` (``<arch>/<shape>/<i>``: its output leaves), and what compat's
    collectives moved in fm's ``serve_p99`` (as JSON)."""
    import json

    from repro_torch.parallel import compat
    out = {}
    for arch, shape in cells:
        cell, cfg, args = serve_inputs(arch, shape)
        fn = cell.build(mesh)[0]
        with compat.count_collectives() as log:
            got = fn(*serve_args_on(cfg, args))
        for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
            out[f"{arch}/{shape}/{i}"] = t.numpy()
        if (arch, shape) == ("fm", "serve_p99"):
            out["collectives"] = np.array(json.dumps(log.record(), sort_keys=True))
    return out


LM_CELLS = [(arch, shape) for arch in ("starcoder2-3b", "stablelm-3b", "h2o-danube-1.8b")
            for shape in ("prefill_32k", "decode_32k")] + [("h2o-danube-1.8b", "long_500k")]
# decode positions: the reduced decode_32k ring of 64 slots at 40 (over 2
# sequence shards, one full, one partial); long_500k's ring of 16 slots past
# its wrap (every shard full)
LM_POS = {"decode_32k": 40, "long_500k": 21}


def lm_inputs(arch: str, shape: str, *, multi_pod: bool = False, seed: int = 0,
              pos: "int | None" = None):
    """A reduced dense LM prefill or decode cell and its seeded numpy inputs:
    ``(cell, cfg, args)`` — parameters as ``numpy_params`` draws them,
    tokens over the vocabulary, a decode cache |normal × 0.05| and its
    position (LM_POS unless ``pos``) as an int32 scalar."""
    from repro_torch.configs import build_cells, get_arch
    from repro_torch.models.transformer import lm_param_defs
    cfg = get_arch(arch).reduced_config()
    cell = build_cells(arch, multi_pod=multi_pod, reduced=True)[shape]
    defs = lm_param_defs(cfg)
    params = _nested(defs, numpy_params(defs, seed))
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab, tuple(cell.args[-1 if cell.kind == "prefill" else 2]
                                              .shape)).astype(np.int32)
    if cell.kind == "prefill":
        return cell, cfg, (params, tokens)
    cache = {k: np.abs(rng.standard_normal(tuple(cell.args[1][k].shape)) * 0.05
                       ).astype(np.float32) for k in sorted(cell.args[1])}
    return cell, cfg, (params, cache, tokens, np.int32(LM_POS[shape] if pos is None else pos))


def lm_args_on(args, device="cpu") -> tuple:
    """``lm_inputs``' numpy arguments as the port's tensors (a fresh cache:
    the decode writes its slot in place)."""
    def tree(a):
        if isinstance(a, dict):
            return {k: tree(v) for k, v in a.items()}
        return torch.from_numpy(np.array(a)).to(device)
    return tuple(tree(a) for a in args)


def sharded_lm_outputs(mesh, cells=LM_CELLS) -> dict:
    """Each reduced dense LM prefill and decode cell's sharded function on
    ``mesh`` (``<arch>/<shape>/<i>``: logits, then the cache's k and v),
    and what compat's collectives moved (``<arch>/<shape>/collectives``,
    as JSON)."""
    import json

    from repro_torch.parallel import compat
    out = {}
    for arch, shape in cells:
        cell, cfg, args = lm_inputs(arch, shape)
        fn = cell.build(mesh)[0]
        with compat.count_collectives() as log:
            logits, cache = fn(*lm_args_on(args))
        for i, t in enumerate((logits, cache["k"], cache["v"])):
            out[f"{arch}/{shape}/{i}"] = t.numpy()
        out[f"{arch}/{shape}/collectives"] = np.array(json.dumps(log.record(), sort_keys=True))
    return out


def serve_collectives(mesh) -> dict:
    """fm's serve_p99 and starcoder2-3b's prefill_32k and decode_32k on
    ``mesh``: the dry-run test's rank side."""
    out = sharded_serve_outputs(mesh, [("fm", "serve_p99")])
    out.update(sharded_lm_outputs(mesh, [("starcoder2-3b", "prefill_32k"),
                                         ("starcoder2-3b", "decode_32k")]))
    return out


# case: (mesh shape, outputs)
CASES = {"search": ((4, 2), search_outputs), "lookup": ((2, 4), lookup_outputs),
         "bert4rec": ((1, 4), bert4rec_outputs), "ep_moe": ((4, 2), ep_moe_outputs),
         "sharded_train": ((4, 2), sharded_train_outputs),
         "sharded_serve": ((2, 2), sharded_serve_outputs),
         "sharded_lm": ((2, 2), sharded_lm_outputs),
         "serve_collectives": ((2, 2), serve_collectives)}


def _rank(rank: int, case: str, world: int, workdir: str) -> None:
    import torch.distributed as dist

    from repro_torch.parallel.compat import RankMesh
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        shape, outputs = CASES[case]
        out = outputs(RankMesh(shape, ("data", "model"), device="cpu"))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def main(case: str, world: int, workdir: str) -> None:
    import torch.multiprocessing as mp
    if world != int(np.prod(CASES[case][0])):
        raise ValueError(f"case {case} runs on {CASES[case][0]}, not {world} ranks")
    mp.spawn(_rank, args=(case, world, workdir), nprocs=world, join=True,
             start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])

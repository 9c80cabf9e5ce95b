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


# case: (mesh shape, outputs)
CASES = {"search": ((4, 2), search_outputs), "lookup": ((2, 4), lookup_outputs),
         "bert4rec": ((1, 4), bert4rec_outputs), "ep_moe": ((4, 2), ep_moe_outputs)}


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

"""Synthetic graphs + the neighbor sampler for minibatch GNN training — a
copy of ``repro/data/graphs.py`` (numpy: the same seed gives the same
arrays).

``NeighborSampler`` is the real host-side component the `minibatch_lg` shape
requires (fanout 15-10 over a large graph): CSR adjacency, per-seed uniform
neighbor sampling with replacement-free truncation, padded fixed-shape
subgraph output (src/dst index arrays with the dump-node convention of
repro_torch.models.gnn).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def synth_graph(n_nodes: int, avg_degree: int, d_feat: int, *, seed: int = 0):
    """Power-law-ish random graph as CSR + features + targets."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    # preferential-attachment-flavored endpoints (hub-heavy like real graphs)
    src = (rng.zipf(1.5, n_edges) % n_nodes).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr)
    feat = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    return {"indptr": indptr, "neighbors": src, "feat": feat,
            "n_nodes": n_nodes}


@dataclasses.dataclass
class NeighborSampler:
    """Layer-wise uniform neighbor sampling (GraphSAGE style)."""

    graph: dict
    fanout: tuple[int, ...] = (15, 10)
    seed: int = 0

    def sample(self, seeds: np.ndarray, step: int = 0) -> dict:
        """Returns a padded subgraph:

        feat (N_pad, F), src/dst (E_pad,) with dump id N_pad for padding,
        seed_mask (N_pad,) float — 1.0 on the seed nodes (loss mask),
        n_real_nodes/int. Subgraph node 0..len(seeds)-1 == seeds.
        """
        g = self.graph
        rng = np.random.default_rng((self.seed, step))
        indptr, nbrs = g["indptr"], g["neighbors"]

        nodes = list(seeds.astype(np.int64))
        node_ix = {int(n): i for i, n in enumerate(nodes)}
        edges_src: list[int] = []
        edges_dst: list[int] = []
        frontier = list(seeds.astype(np.int64))
        for f in self.fanout:
            nxt: list[int] = []
            for u in frontier:
                lo, hi = indptr[u], indptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                picks = rng.choice(deg, size=take, replace=False)
                for p in picks:
                    v = int(nbrs[lo + p])
                    if v not in node_ix:
                        node_ix[v] = len(nodes)
                        nodes.append(v)
                    # message flows v -> u
                    edges_src.append(node_ix[v])
                    edges_dst.append(node_ix[int(u)])
                    nxt.append(v)
            frontier = nxt

        # pad to the static shapes of the minibatch cell:
        # N_pad = seeds + seeds·f1 + seeds·f1·f2 ...
        n_seeds = len(seeds)
        N_pad, E_pad = padded_sizes(n_seeds, self.fanout)
        n_real = len(nodes)
        feat = np.zeros((N_pad, g["feat"].shape[1]), np.float32)
        feat[:n_real] = g["feat"][np.asarray(nodes)]
        src = np.full(E_pad, N_pad, np.int32)
        dst = np.full(E_pad, N_pad, np.int32)
        src[:len(edges_src)] = edges_src
        dst[:len(edges_dst)] = edges_dst
        seed_mask = np.zeros(N_pad, np.float32)
        seed_mask[:n_seeds] = 1.0
        return {"feat": feat, "src": src, "dst": dst,
                "node_mask": seed_mask, "n_real_nodes": n_real}


def padded_sizes(n_seeds: int, fanout: tuple[int, ...]) -> tuple[int, int]:
    """Static (N_pad, E_pad) for a fanout sample rooted at n_seeds."""
    N = n_seeds
    E = 0
    layer = n_seeds
    for f in fanout:
        layer = layer * f
        N += layer
        E += layer
    return N, E


def molecule_batch(n_graphs: int, n_nodes: int, n_edges: int, d_feat: int,
                   d_out: int, *, seed: int = 0) -> dict:
    """Batched random molecular graphs (undirected edge pairs)."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(n_graphs, n_nodes, d_feat)).astype(np.float32)
    src = rng.integers(0, n_nodes, (n_graphs, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, (n_graphs, n_edges)).astype(np.int32)
    target = rng.normal(size=(n_graphs, n_nodes, d_out)).astype(np.float32)
    mask = np.ones((n_graphs, n_nodes), np.float32)
    return {"feat": feat, "src": src, "dst": dst, "target": target,
            "node_mask": mask}

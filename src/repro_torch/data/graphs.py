"""Graph data of the port — its own numpy copy of ``repro.data.graphs``,
so the same seed gives the same arrays bit for bit: synthetic graphs,
batched molecules, and a *real* neighbor sampler (uniform fanout,
GraphSAGE-style) for the minibatch_lg cell.

The sampler keeps the full graph in host CSR and emits fixed-shape padded
subgraphs (nodes, edges, src, dst, masks) so every training step has the
same shapes. Shapes are the worst case of the fanout product; real
occupancy is tracked through the masks. Its draws and arrays are the
reference's; it keeps a running count of a hop's picks where the
reference sums them again for every node (a cost quadratic in the
frontier: 1.2e8 additions for minibatch_lg's second hop).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def random_graph(n_nodes: int, n_edges: int, d_feat: int, d_edge: int = 8,
                 d_out: int = 3, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    return {
        "nodes": rng.normal(size=(n_nodes, d_feat)).astype(np.float32),
        "edges": rng.normal(size=(n_edges, d_edge)).astype(np.float32),
        "src": src, "dst": dst,
        "edge_mask": np.ones(n_edges, bool),
        "node_mask": np.ones(n_nodes, bool),
        "targets": rng.normal(size=(n_nodes, d_out)).astype(np.float32),
    }


def molecule_batch(n_graphs: int, nodes_per: int, edges_per: int,
                   d_feat: int, d_edge: int = 8, d_out: int = 3,
                   seed: int = 0) -> dict:
    """Disjoint union of small graphs (the ``molecule`` cell)."""
    rng = np.random.default_rng(seed)
    N, E = n_graphs * nodes_per, n_graphs * edges_per
    offs = np.repeat(np.arange(n_graphs) * nodes_per, edges_per)
    src = (rng.integers(0, nodes_per, size=E) + offs).astype(np.int32)
    dst = (rng.integers(0, nodes_per, size=E) + offs).astype(np.int32)
    return {
        "nodes": rng.normal(size=(N, d_feat)).astype(np.float32),
        "edges": rng.normal(size=(E, d_edge)).astype(np.float32),
        "src": src, "dst": dst,
        "edge_mask": np.ones(E, bool), "node_mask": np.ones(N, bool),
        "targets": rng.normal(size=(N, d_out)).astype(np.float32),
    }


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (nnz,)
    feats: np.ndarray       # (N, d)
    targets: np.ndarray     # (N, d_out)

    @staticmethod
    def from_edges(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                   feats: np.ndarray, targets: np.ndarray) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")
        s, d = src[order], dst[order]
        counts = np.bincount(d, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return CSRGraph(indptr=indptr, indices=s.astype(np.int32),
                        feats=feats, targets=targets)


class NeighborSampler:
    """Uniform fanout sampling with fixed padded output shapes.

    For fanouts (f1, f2): layer-0 seeds B, frontier-1 <= B*f1,
    frontier-2 <= B*f1*f2; edges hop-i connect frontier-i sources to
    frontier-(i-1) targets, exactly the shapes declared in the
    minibatch_lg input spec.
    """

    def __init__(self, graph: CSRGraph, fanouts: Sequence[int],
                 batch_nodes: int, d_edge: int = 8, seed: int = 0):
        self.g = graph
        self.fanouts = tuple(fanouts)
        self.batch_nodes = batch_nodes
        self.d_edge = d_edge
        self.rng = np.random.default_rng(seed)
        self.max_nodes, self.max_edges = self.shape_bounds()

    def shape_bounds(self) -> Tuple[int, int]:
        n, e = self.batch_nodes, 0
        frontier = self.batch_nodes
        for f in self.fanouts:
            e += frontier * f
            frontier *= f
            n += frontier
        return n, e

    def sample(self) -> dict:
        g = self.g
        n_total = g.indptr.shape[0] - 1
        seeds = self.rng.integers(0, n_total, size=self.batch_nodes)
        node_list = [seeds]
        edge_src_local, edge_dst_local = [], []
        frontier = seeds
        base = 0
        for f in self.fanouts:
            nbr_rows = []
            srcs, dsts = [], []
            next_base = base + len(frontier)
            taken = 0           # picks of this hop so far (the reference
            for i, node in enumerate(frontier):   # re-sums them per node)
                lo, hi = g.indptr[node], g.indptr[node + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, deg)
                picks = g.indices[lo + self.rng.choice(deg, size=take,
                                                       replace=False)]
                nbr_rows.append(picks)
                srcs.append(np.arange(len(picks)) + next_base + taken)
                taken += len(picks)
                dsts.append(np.full(len(picks), base + i))
            if nbr_rows:
                frontier = np.concatenate(nbr_rows)
                edge_src_local.append(np.concatenate(srcs))
                edge_dst_local.append(np.concatenate(dsts))
            else:
                frontier = np.array([], dtype=np.int64)
            node_list.append(frontier)
            base = next_base

        nodes = np.concatenate(node_list)
        n_real = nodes.shape[0]
        e_real = sum(len(s) for s in edge_src_local)
        N, E = self.max_nodes, self.max_edges
        feats = np.zeros((N, g.feats.shape[1]), np.float32)
        feats[:n_real] = g.feats[nodes]
        targets = np.zeros((N, g.targets.shape[1]), np.float32)
        targets[:n_real] = g.targets[nodes]
        src = np.zeros(E, np.int32)
        dst = np.zeros(E, np.int32)
        if e_real:
            src[:e_real] = np.concatenate(edge_src_local)
            dst[:e_real] = np.concatenate(edge_dst_local)
        edge_mask = np.zeros(E, bool)
        edge_mask[:e_real] = True
        node_mask = np.zeros(N, bool)
        node_mask[:self.batch_nodes] = True   # loss only on seed nodes
        rngf = self.rng.normal(size=(E, self.d_edge)).astype(np.float32)
        return {
            "nodes": feats, "edges": rngf, "src": src, "dst": dst,
            "edge_mask": edge_mask, "node_mask": node_mask,
            "targets": targets,
        }

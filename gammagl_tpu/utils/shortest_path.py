"""All-pairs shortest path + padded spatial-encoding precompute
(Graphormer).

Reference: gammagl/utils/shortest_path.py (networkx all-pairs BFS per
graph, ragged dict output). Here the hot path is scipy's C BFS over a
CSR adjacency, and `bucketed_spatial_encoding` emits the STATIC-shape
padded batches jit needs: per-bucket (B, S, S) int32 distance
tensors with clamped distances, so one jit specialization serves every
graph that falls in the bucket (SURVEY.md §7 padding discipline; the
reference never faces this because eager backends tolerate ragged
shapes).
"""

import numpy as np

__all__ = ["shortest_path", "bucketed_spatial_encoding"]


def shortest_path(edge_index, num_nodes, max_dist=None, clip_far=True):
    """Dense (N, N) hop-distance matrix; unreachable pairs get -1.

    Uses scipy.sparse.csgraph (C BFS) when available — ~100x the pure
    Python BFS at ogbg scales — with the original list-BFS fallback.

    `max_dist` handling (Graphormer spatial encoding): with the default
    ``clip_far=True``, REACHABLE pairs farther than `max_dist` clamp to
    `max_dist` (they share the encoder's "far" embedding bucket — the
    published Graphormer's SPD clip) while unreachable pairs stay -1
    (the "no spatial relation" row). ``clip_far=False`` restores the
    truncated-BFS semantics where far pairs also land at -1 (everything
    beyond `max_dist` reads as "no relation").
    """
    ei = np.asarray(edge_index)
    try:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import shortest_path as _sp
        adj = sp.csr_matrix(
            (np.ones(ei.shape[1], np.int8), (ei[0], ei[1])),
            shape=(num_nodes, num_nodes))
        dist = _sp(adj, method="D", unweighted=True, directed=True)
        out = np.where(np.isinf(dist), -1, dist).astype(np.int64)
    except ImportError:  # pragma: no cover - scipy is a baked-in dep
        out = _bfs_python(ei, num_nodes)
    if max_dist is not None:
        out = np.where(out > max_dist, max_dist if clip_far else -1, out)
    return out


def _bfs_python(ei, num_nodes):
    adj = [[] for _ in range(num_nodes)]
    for s, d in ei.T:
        adj[s].append(int(d))
    dist = np.full((num_nodes, num_nodes), -1, dtype=np.int64)
    for start in range(num_nodes):
        dist[start, start] = 0
        frontier = [start]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[start, v] < 0:
                        dist[start, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


def bucketed_spatial_encoding(graphs, buckets=(16, 32, 64, 128),
                              max_dist=8):
    """Pad per-graph distance matrices into static-shape buckets.

    Args:
      graphs: iterable of objects with `edge_index` and `num_nodes`
        (Graph pytrees or plain namespaces).
      buckets: ascending node-count bucket sizes; each graph lands in
        the smallest bucket that fits (larger graphs get their own
        exact-size bucket, still padded to a multiple of 8 rows).
      max_dist: distance clip for the spatial embedding table.

    Returns dict: bucket_size -> {
        "dist":  (B, S, S) int32, padding rows/cols = -1,
        "mask":  (B, S) bool valid-node mask,
        "index": list of positions of these graphs in `graphs`,
    }. Unreachable and padded pairs share the -1 id — both map to the
    Graphormer "no spatial relation" embedding row
    (layers/attention/graphormer.py), so padding is exact under jit.
    """
    out = {}
    for pos, g in enumerate(graphs):
        n = int(g.num_nodes)
        size = next((b for b in buckets if n <= b),
                    -(-n // 8) * 8)
        d = shortest_path(np.asarray(g.edge_index), n, max_dist=max_dist)
        pad = np.full((size, size), -1, np.int32)
        pad[:n, :n] = d
        mask = np.zeros(size, bool)
        mask[:n] = True
        slot = out.setdefault(size, {"dist": [], "mask": [], "index": []})
        slot["dist"].append(pad)
        slot["mask"].append(mask)
        slot["index"].append(pos)
    return {
        size: {"dist": np.stack(v["dist"]), "mask": np.stack(v["mask"]),
               "index": v["index"]}
        for size, v in out.items()
    }

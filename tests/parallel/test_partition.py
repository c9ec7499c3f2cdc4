import numpy as np


def test_balance_permutation_equalizes_edges():
    from gammagl_tpu.parallel import balance_permutation
    from gammagl_tpu.parallel.halo import build_halo_partition
    rng = np.random.default_rng(0)
    n, e, p = 1000, 20000, 4
    # power-law dst: natural block partition is heavily imbalanced
    dst = (n * (rng.random(e) ** 2.0)).astype(np.int64)
    src = rng.integers(0, n, e)
    ei = np.stack([src, dst])
    perm, inv = balance_permutation(ei, n, p)
    # perm/inv are inverse dense relabelings
    assert np.array_equal(np.sort(inv), np.arange(n))
    assert np.array_equal(inv[perm], np.arange(n))
    part_nat = build_halo_partition(ei, n, p, balance=False)
    part_bal = build_halo_partition(inv[ei], n, p, balance=False)
    assert part_bal.edge_index.shape[2] < 0.7 * part_nat.edge_index.shape[2]
    # aggregation result is the original up to the permutation
    x = rng.normal(size=(n, 3)).astype(np.float32)
    ref = np.zeros((n, 3), np.float32)
    np.add.at(ref, ei[1], x[ei[0]])
    ref2 = np.zeros((n, 3), np.float32)
    ei2 = inv[ei]
    xb = x[perm]
    np.add.at(ref2, ei2[1], xb[ei2[0]])
    np.testing.assert_allclose(ref2, ref[perm], rtol=1e-5)


def test_balance_permutation_tiny_graph_identity():
    from gammagl_tpu.parallel import balance_permutation
    ei = np.asarray([[0, 1], [1, 2]])
    perm, inv = balance_permutation(ei, 3, 8)
    assert np.array_equal(perm, np.arange(3))


def test_pad_unpad_nodes_roundtrip_balanced():
    """pad_nodes applies the partition's balanced relabeling;
    unpad_nodes inverts it exactly."""
    from gammagl_tpu.parallel import (build_halo_partition,
                                      pad_nodes, unpad_nodes)
    rng = np.random.default_rng(3)
    n, e, p = 300, 3000, 4
    dst = (n * (rng.random(e) ** 2.0)).astype(np.int64)
    src = rng.integers(0, n, e)
    part = build_halo_partition(np.stack([src, dst]), n, p,
                                np.ones(e, np.float32))
    assert part.node_perm is not None
    x = rng.normal(size=(n, 5)).astype(np.float32)
    padded = pad_nodes(x, part)
    assert padded.shape[0] == part.num_parts * part.rows_per
    np.testing.assert_array_equal(unpad_nodes(padded, part), x)

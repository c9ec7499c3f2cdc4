"""Raw-format fixture tests: every dataset reader parses a fabricated
byte-realistic raw payload offline (the reference
exercises each reader via download tests, tests/datasets/*; here the raw
formats are fabricated so every `process()` path runs in CI without
network).

Formats mirror the reference parsers:
 - npz CSR graphs:      reference gammagl/io/npz.py
 - geom-gcn text:       reference gammagl/datasets/{webkb,actor}.py
 - SAINT json/npz:      reference gammagl/datasets/flickr.py
 - PPI ndjson/npy:      reference gammagl/datasets/ppi.py
 - Reddit npz:          reference gammagl/datasets/reddit.py
 - Entities N-Triples:  reference gammagl/datasets/entities.py
 - HGB .dat:            reference gammagl/datasets/hgb.py
"""

import gzip
import json
import os
import os.path as osp
import pickle
import zipfile

import numpy as np
import pytest
import scipy.sparse as sp


def _csr_npz_payload(x, adj, y):
    """Amazon/Coauthor raw format: CSR attr + CSR adj + labels keys."""
    xs = sp.csr_matrix(x)
    asp = sp.csr_matrix(adj)
    return dict(
        attr_data=xs.data, attr_indices=xs.indices, attr_indptr=xs.indptr,
        attr_shape=np.asarray(xs.shape),
        adj_data=asp.data, adj_indices=asp.indices, adj_indptr=asp.indptr,
        adj_shape=np.asarray(asp.shape), labels=y)


def _random_graph(n=12, f=6, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, f)) > 0.5).astype(np.float32)
    adj = (rng.random((n, n)) < 0.3).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int64)
    return x, adj, y


def test_amazon_npz(tmp_path):
    from gammagl_tpu.datasets import Amazon
    x, adj, y = _random_graph()
    raw = tmp_path / "computers" / "raw"
    raw.mkdir(parents=True)
    np.savez(raw / "amazon_electronics_computers.npz",
             **_csr_npz_payload(x, adj, y))
    ds = Amazon(root=str(tmp_path), name="computers")
    g = ds[0]
    assert g.x.shape == (12, 6)
    assert np.asarray(g.y).shape == (12,)
    ei = np.asarray(g.edge_index)
    assert (ei[0] != ei[1]).all()  # self-loops removed


def test_coauthor_npz(tmp_path):
    from gammagl_tpu.datasets import Coauthor
    x, adj, y = _random_graph(seed=1)
    raw = tmp_path / "cs" / "raw"
    raw.mkdir(parents=True)
    np.savez(raw / "ms_academic_cs.npz", **_csr_npz_payload(x, adj, y))
    ds = Coauthor(root=str(tmp_path), name="cs")
    assert ds[0].num_nodes == 12


@pytest.mark.parametrize("cls_name,fname,keys", [
    ("FacebookPagePage", "facebook.npz",
     ("features", "edges", "target")),
    ("DeezerEurope", "deezer_europe.npz", ("features", "edges", "target")),
    ("GitHub", "git_web_sp.npz", ("x", "edge_index", "y")),
])
def test_single_npz(tmp_path, cls_name, fname, keys):
    import gammagl_tpu.datasets as D
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    payload = {}
    n = 10
    payload[keys[0]] = rng.random((n, 4)).astype(np.float32)
    e = rng.integers(0, n, (2, 30))
    payload[keys[1]] = e.T if keys[1] == "edges" else e
    payload[keys[2]] = rng.integers(0, 3, n)
    np.savez(raw / fname, **payload)
    ds = getattr(D, cls_name)(root=str(tmp_path))
    g = ds[0]
    assert g.x.shape == (n, 4)
    assert np.asarray(g.edge_index).shape == (2, 30)


def test_ppi_raw(tmp_path):
    from gammagl_tpu.datasets import PPI
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    # two graphs of 5 nodes per split
    for split in ("train", "valid", "test"):
        n = 10
        links = [{"source": int(a), "target": int(b)}
                 for a, b in rng.integers(0, 5, (8, 2))]
        links += [{"source": int(a) + 5, "target": int(b) + 5}
                  for a, b in rng.integers(0, 5, (8, 2))]
        with open(raw / f"{split}_graph.json", "w") as f:
            json.dump({"links": links}, f)
        np.save(raw / f"{split}_feats.npy",
                rng.random((n, 7)).astype(np.float32))
        np.save(raw / f"{split}_labels.npy",
                rng.integers(0, 2, (n, 3)).astype(np.float32))
        np.save(raw / f"{split}_graph_id.npy",
                np.repeat([3, 4], 5))  # ids need not start at 0
    for split, expected in (("train", 2), ("val", 2), ("test", 2)):
        ds = PPI(root=str(tmp_path), split=split)
        assert len(ds) == expected
        assert ds[0].x.shape[1] == 7
        assert ds[0].y.shape[1] == 3


def test_reddit_raw(tmp_path):
    from gammagl_tpu.datasets import Reddit
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    n = 20
    np.savez(raw / "reddit_data.npz",
             feature=rng.random((n, 8)).astype(np.float32),
             label=rng.integers(0, 5, n),
             node_types=rng.integers(1, 4, n))
    adj = sp.csr_matrix((rng.random((n, n)) < 0.2).astype(np.float32))
    sp.save_npz(raw / "reddit_graph.npz", adj)
    ds = Reddit(root=str(tmp_path))
    g = ds[0]
    assert g.num_nodes == n
    masks = (np.asarray(g.train_mask) | np.asarray(g.val_mask)
             | np.asarray(g.test_mask))
    assert masks.all()


@pytest.mark.parametrize("cls_name,multilabel", [("Flickr", False),
                                                 ("Yelp", True)])
def test_saint_raw(tmp_path, cls_name, multilabel):
    import gammagl_tpu.datasets as D
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    n = 15
    adj = sp.csr_matrix((rng.random((n, n)) < 0.25).astype(np.float32))
    np.savez(raw / "adj_full.npz", data=adj.data, indices=adj.indices,
             indptr=adj.indptr, shape=np.asarray(adj.shape))
    np.save(raw / "feats.npy", rng.random((n, 5)))
    if multilabel:
        cmap = {str(i): rng.integers(0, 2, 4).tolist() for i in range(n)}
    else:
        cmap = {str(i): int(rng.integers(0, 3)) for i in range(n)}
    with open(raw / "class_map.json", "w") as f:
        json.dump(cmap, f)
    ids = rng.permutation(n)
    with open(raw / "role.json", "w") as f:
        json.dump({"tr": ids[:8].tolist(), "va": ids[8:11].tolist(),
                   "te": ids[11:].tolist()}, f)
    ds = getattr(D, cls_name)(root=str(tmp_path))
    g = ds[0]
    assert g.x.shape == (n, 5)
    assert np.asarray(g.train_mask).sum() == 8
    if multilabel:
        assert np.asarray(g.y).shape == (n, 4)


def test_wikics_raw(tmp_path):
    from gammagl_tpu.datasets import WikiCS
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    n = 12
    data = {
        "features": rng.random((n, 4)).tolist(),
        "labels": rng.integers(0, 3, n).tolist(),
        "links": [rng.integers(0, n, 3).tolist() for _ in range(n)],
        "train_masks": (rng.random((20, n)) < 0.5).tolist(),
        "val_masks": (rng.random((20, n)) < 0.3).tolist(),
        "stopping_masks": (rng.random((20, n)) < 0.3).tolist(),
        "test_mask": (rng.random(n) < 0.3).tolist(),
    }
    with open(raw / "data.json", "w") as f:
        json.dump(data, f)
    ds = WikiCS(root=str(tmp_path))
    g = ds[0]
    assert g.x.shape == (n, 4)
    assert np.asarray(g.train_mask).shape == (n, 20)


def _write_geom_gcn_raw(raw, name, n=10, f=5, c=3, sparse_feats=False,
                        seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(raw, exist_ok=True)
    lines = ["node_id\tfeature\tlabel"]
    for i in range(n):
        if sparse_feats:  # Actor format: comma list of active indices
            feats = ",".join(str(v) for v in
                             sorted(set(rng.integers(0, 932, 4).tolist())))
        else:
            feats = ",".join(f"{v:.3f}" for v in rng.random(f))
        lines.append(f"{i}\t{feats}\t{rng.integers(0, c)}")
    with open(osp.join(raw, "out1_node_feature_label.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    edges = ["src\tdst"] + [f"{a}\t{b}" for a, b in
                            rng.integers(0, n, (25, 2))]
    with open(osp.join(raw, "out1_graph_edges.txt"), "w") as fh:
        fh.write("\n".join(edges) + "\n")
    for i in range(10):
        masks = rng.integers(0, 3, n)
        np.savez(osp.join(raw, f"{name}_split_0.6_0.2_{i}.npz"),
                 train_mask=(masks == 0).astype(np.uint8),
                 val_mask=(masks == 1).astype(np.uint8),
                 test_mask=(masks == 2).astype(np.uint8))


def test_webkb_raw(tmp_path):
    from gammagl_tpu.datasets import WebKB
    _write_geom_gcn_raw(str(tmp_path / "cornell" / "raw"), "cornell")
    ds = WebKB(root=str(tmp_path), name="cornell")
    g = ds[0]
    assert g.x.shape == (10, 5)
    assert np.asarray(g.train_mask).shape == (10, 10)


def test_wikipedia_network_raw(tmp_path):
    from gammagl_tpu.datasets import WikipediaNetwork
    _write_geom_gcn_raw(str(tmp_path / "chameleon" / "raw"), "chameleon")
    ds = WikipediaNetwork(root=str(tmp_path), name="chameleon")
    assert ds[0].num_nodes == 10


def test_actor_raw(tmp_path):
    from gammagl_tpu.datasets import Actor
    _write_geom_gcn_raw(str(tmp_path / "film" / "raw"), "film",
                        sparse_feats=True)
    ds = Actor(root=str(tmp_path))
    g = ds[0]
    assert g.x.shape == (10, 932)
    assert set(np.unique(np.asarray(g.x))) <= {0.0, 1.0}


def test_polblogs_raw(tmp_path):
    from gammagl_tpu.datasets import PolBlogs
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    with open(raw / "adjacency.tsv", "w") as f:
        for a, b in rng.integers(0, 8, (20, 2)):
            f.write(f"{a}\t{b}\t1\n")
    with open(raw / "labels.tsv", "w") as f:
        f.write("\n".join(str(int(v)) for v in rng.integers(0, 2, 8)))
    ds = PolBlogs(root=str(tmp_path))
    g = ds[0]
    assert g.num_nodes == 8
    assert np.asarray(g.edge_index).shape == (2, 20)


def test_blogcatalog_raw(tmp_path):
    from gammagl_tpu.datasets import BlogCatalog
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    n = 9
    inner = tmp_path / "payload" / "blogcatalog"
    inner.mkdir(parents=True)
    adj = sp.csr_matrix((rng.random((n, n)) < 0.3).astype(np.float32))
    sp.save_npz(inner / "adj.npz", adj)
    np.savez(inner / "attr.npz", rng.random((n, 6)).astype(np.float32))
    np.save(inner / "label.npy", rng.integers(0, 3, n))
    with zipfile.ZipFile(raw / "blogcatalog.zip", "w") as z:
        for f in inner.iterdir():
            z.write(f, arcname=f"blogcatalog/{f.name}")
    ds = BlogCatalog(root=str(tmp_path))
    g = ds[0]
    assert np.asarray(g.y).shape == (n,)


def test_ca_grqc_raw(tmp_path):
    from gammagl_tpu.datasets import CAGrQc
    raw = tmp_path / "raw"
    raw.mkdir()
    with open(raw / "ca-GrQc.txt", "w") as f:
        f.write("# comment line\n# another\n")
        # non-contiguous ids: the reader must relabel
        for a, b in [(100, 200), (200, 300), (300, 100), (400, 200)]:
            f.write(f"{a}\t{b}\n")
    ds = CAGrQc(root=str(tmp_path))
    g = ds[0]
    assert g.num_nodes == 4
    assert int(np.asarray(g.edge_index).max()) == 3


def test_airports_raw(tmp_path):
    from gammagl_tpu.datasets import Airports
    raw = tmp_path / "usa" / "raw"
    raw.mkdir(parents=True)
    # labels file has a header line; node ids are arbitrary ints
    with open(raw / "labels-usa-airports.txt", "w") as f:
        f.write("node label\n17 0\n42 1\n99 1\n7 0\n")
    with open(raw / "usa-airports.edgelist", "w") as f:
        f.write("17 42\n42 99\n99 7\n")
    ds = Airports(root=str(tmp_path), name="usa")
    g = ds[0]
    assert g.num_nodes == 4
    assert g.x.shape[0] == 4  # one-hot degree features


def test_entities_raw_nt(tmp_path):
    from gammagl_tpu.datasets import Entities
    raw = tmp_path / "aifb" / "raw"
    raw.mkdir(parents=True)
    people = [f"<http://ex.org/person{i}>" for i in range(4)]
    affs = ["<http://ex.org/aff0>", "<http://ex.org/aff1>"]
    nt_lines = []
    for i, p in enumerate(people):
        nt_lines.append(
            f"{p} <http://ex.org/member> {affs[i % 2]} .")
        nt_lines.append(
            f"{p} <http://ex.org/knows> {people[(i + 1) % 4]} .")
    with gzip.open(raw / "aifb_stripped.nt.gz", "wt") as f:
        f.write("\n".join(nt_lines) + "\n")
    header = "id\tperson\tlabel_affiliation\n"
    with open(raw / "trainingSet.tsv", "w") as f:
        f.write(header)
        for i in (0, 1):
            f.write(f"{i}\thttp://ex.org/person{i}\t"
                    f"http://ex.org/aff{i % 2}\n")
    with open(raw / "testSet.tsv", "w") as f:
        f.write(header)
        for i in (2, 3):
            f.write(f"{i}\thttp://ex.org/person{i}\t"
                    f"http://ex.org/aff{i % 2}\n")
    with open(raw / "completeDataset.tsv", "w") as f:
        f.write(header)
    ds = Entities(root=str(tmp_path), name="aifb")
    g = ds[0]
    assert g.num_relations == 2
    assert np.asarray(g.edge_type).shape[0] == 8
    assert len(np.asarray(g.train_idx)) == 2
    assert len(np.asarray(g.test_y)) == 2


def test_zinc_raw(tmp_path):
    from gammagl_tpu.datasets import ZINC
    raw = tmp_path / "raw" / "molecules"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        mols = []
        for _ in range(3):
            n = int(rng.integers(3, 6))
            bond = np.triu(rng.integers(0, 3, (n, n)), 1)
            bond = bond + bond.T
            mols.append({
                "atom_type": rng.integers(0, 20, n),
                "bond_type": bond,
                "logP_SA_cycle_normalized": float(rng.random()),
            })
        with open(raw / f"{split}.pickle", "wb") as f:
            pickle.dump(mols, f)
    ds = ZINC(root=str(tmp_path), split="val")
    assert len(ds) == 3
    g = ds[0]
    assert g.x.ndim == 2 and g.x.shape[1] == 1
    ei = np.asarray(g.edge_index)
    assert np.asarray(g.edge_attr).shape == (ei.shape[1],)


def test_acm4heco_raw(tmp_path):
    from gammagl_tpu.datasets import ACM4HeCo
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    n_p, n_a, n_s = 8, 5, 3
    sp.save_npz(raw / "p_feat.npz",
                sp.csr_matrix(rng.random((n_p, 6)).astype(np.float32)))
    np.save(raw / "labels.npy", rng.integers(0, 3, n_p))
    np.savetxt(raw / "pa.txt",
               np.stack([rng.integers(0, n_p, 12),
                         rng.integers(0, n_a, 12)], 1), fmt="%d")
    np.savetxt(raw / "ps.txt",
               np.stack([np.arange(n_p), rng.integers(0, n_s, n_p)], 1),
               fmt="%d")
    for ratio in (20, 40, 60):
        for split in ("train", "val", "test"):
            np.save(raw / f"{split}_{ratio}.npy",
                    rng.permutation(n_p)[:3])
    ds = ACM4HeCo(root=str(tmp_path))
    hg = ds[0]
    assert hg["paper"].x.shape == (n_p, 6)
    assert hg[("author", "ap", "paper")].edge_index.shape == (2, 12)
    assert hg["paper"]["train_20"].shape == (3,)


@pytest.mark.parametrize("cls_name", ["Bail", "Credit"])
def test_fairness_raw(tmp_path, cls_name):
    import gammagl_tpu.datasets as D
    cls = getattr(D, cls_name)
    name = cls.name
    raw = tmp_path / name / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for p in cls.parts:
        n = 6
        feats = rng.random((n, 4))
        feats[:, -1] = rng.integers(0, 2, n)  # label column
        header = ",".join(f"f{i}" for i in range(4))
        np.savetxt(raw / f"{name}{p}.csv", feats, delimiter=",",
                   header=header, comments="")
        np.savetxt(raw / f"{name}{p}_edges.txt",
                   rng.integers(0, n, (10, 2)), fmt="%d")
    ds = cls(root=str(tmp_path))
    assert len(ds) == 5
    g = ds[0]
    assert g.x.shape == (6, 3)
    assert hasattr(g, "sens")


def test_aminer_raw(tmp_path):
    from gammagl_tpu.datasets import AMiner
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    np.savetxt(raw / "paper_author.txt",
               np.stack([rng.integers(0, 7, 15),
                         rng.integers(0, 4, 15)], 1), fmt="%d")
    np.savetxt(raw / "paper_conf.txt",
               np.stack([np.arange(7), rng.integers(0, 2, 7)], 1),
               fmt="%d")
    for f in ("id_author.txt", "id_conf.txt", "paper.txt"):
        (raw / f).write_text("")
    (raw / "label").mkdir()
    ds = AMiner(root=str(tmp_path))
    hg = ds[0]
    assert hg["paper"].num_nodes == 7
    assert hg[("venue", "publishes", "paper")].edge_index.shape == (2, 7)


def test_moleculenet_raw(tmp_path, monkeypatch):
    from gammagl_tpu.datasets import MoleculeNet
    from gammagl_tpu.data.graph import Graph
    raw = tmp_path / "esol" / "raw"
    raw.mkdir(parents=True)
    with open(raw / "delaney-processed.csv", "w") as f:
        f.write("smiles,measured log solubility in mols per litre\n")
        f.write("CCO,-0.5\nC1CC1,1.25\nbadrow,not_a_float\n")

    def fake_from_smiles(s):
        n = len(s)
        return Graph(x=np.zeros((n, 9), np.int64),
                     edge_index=np.stack([np.arange(n - 1),
                                          np.arange(1, n)]).astype(
                         np.int64))

    import gammagl_tpu.utils.smiles as sm
    monkeypatch.setattr(sm, "from_smiles", fake_from_smiles)
    ds = MoleculeNet(root=str(tmp_path), name="esol")
    assert len(ds) == 2  # bad target row dropped
    assert float(ds[1].y[0]) == pytest.approx(1.25)


def test_movielens_raw(tmp_path):
    from gammagl_tpu.datasets import MovieLens
    raw = tmp_path / "raw" / "ml-100k"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = np.stack([rng.integers(1, 6, 20), rng.integers(1, 9, 20),
                     rng.integers(1, 6, 20),
                     rng.integers(0, 10**9, 20)], 1)
    np.savetxt(raw / "u.data", rows, fmt="%d", delimiter="\t")
    (raw / "u.item").write_text("")
    (raw / "u.user").write_text("")
    ds = MovieLens(root=str(tmp_path))
    hg = ds[0]
    assert hg[("user", "rates", "movie")].edge_index.shape == (2, 20)
    assert hg[("user", "rates", "movie")].edge_attr.shape == (20,)


def test_modelnet40_raw(tmp_path):
    h5py = pytest.importorskip("h5py")
    from gammagl_tpu.datasets import ModelNet40
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    for split, k in (("train", 4), ("test", 2)):
        with h5py.File(raw / f"ply_data_{split}0.h5", "w") as f:
            f["data"] = rng.random((k, 64, 3)).astype(np.float32)
            f["label"] = rng.integers(0, 40, (k, 1))
    ds = ModelNet40(root=str(tmp_path), split="train", num_points=32)
    assert len(ds) == 4
    assert ds[0].x.shape == (32, 3)
    ds_t = ModelNet40(root=str(tmp_path), split="test", num_points=32)
    assert len(ds_t) == 2


def test_shapenet_raw(tmp_path):
    from gammagl_tpu.datasets import ShapeNet
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    cat = "02691156"  # Airplane
    # raw_file_names lists every category dir; all must exist to skip
    # download()
    for cid in ShapeNet.category_ids.values():
        (raw / cid).mkdir(parents=True, exist_ok=True)
    split_dir = raw / "train_test_split"
    split_dir.mkdir()
    names = {}
    for split, items in (("train", ["a", "b"]), ("val", ["c"]),
                         ("test", ["d"])):
        for item in items:
            pts = rng.random((20, 6)).astype(np.float32)
            lab = rng.integers(0, 4, (20, 1)).astype(np.float32)
            np.savetxt(raw / cat / f"{item}.txt",
                       np.concatenate([pts, lab], 1))
        names[split] = [f"shape_data/{cat}/{i}" for i in items]
        with open(split_dir / f"shuffled_{split}_file_list.json",
                  "w") as f:
            json.dump(names[split], f)
    ds = ShapeNet(root=str(tmp_path), categories="Airplane",
                  split="trainval")
    assert len(ds) == 3
    g = ds[0]
    assert g.pos.shape == (20, 3)
    assert g.x.shape == (20, 3)


def test_ngsim_raw(tmp_path):
    from gammagl_tpu.datasets import NGSIM_US_101
    raw = tmp_path / "ngsim" / "raw" / "train"
    raw.mkdir(parents=True)
    proc = tmp_path / "ngsim" / "processed" / "train"
    proc.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        item = {"x": rng.random((4, 5, 2)).astype(np.float32),
                "edge_attr": rng.random((5, 6)).astype(np.float32),
                "edge_type": rng.random((5, 4)).astype(np.float32)}
        with open(proc / f"sample_{i}.pkl", "wb") as f:
            pickle.dump(item, f)
    (raw / "train.zip").write_bytes(b"")  # raw present -> no download
    ds = NGSIM_US_101(root=str(tmp_path), name="train")
    assert len(ds) == 3
    g = ds[0]
    assert g.edge_attr.shape == (6, 5)  # axes swapped for the HEAT model


def test_acm4dhn_raw(tmp_path):
    from gammagl_tpu.datasets import ACM4DHN
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(0)
    lines = [f"M{rng.integers(0, 6)} A{rng.integers(0, 4)}"
             for _ in range(20)]
    (raw / "MA.txt").write_text("\n".join(lines) + "\n")
    ds = ACM4DHN(root=str(tmp_path), test_ratio=0.2)
    hg = ds[0]
    full = hg[("M", "MA", "A")].edge_index
    assert full.shape == (2, 20)
    assert (full[1] < 0).all()  # actor ids stored as -id-1
    assert hg["train"][("M", "MA", "A")].edge_index.shape[1] == 12


def test_acm4rohe_raw(tmp_path):
    from scipy import io as sio
    from gammagl_tpu.datasets import ACM4Rohe
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    n_p, n_a, n_f, n_c, n_t = 30, 10, 4, 14, 12
    pvsc = np.zeros((n_p, n_c))
    for i in range(n_p):  # every paper in one of the selected confs
        pvsc[i, [0, 1, 9, 10, 13][i % 5]] = 1
    sio.savemat(raw / "ACM.mat", {
        "PvsL": sp.csr_matrix((rng.random((n_p, n_f)) < 0.4).astype(
            float)),
        "PvsA": sp.csr_matrix((rng.random((n_p, n_a)) < 0.3).astype(
            float)),
        "PvsT": sp.csr_matrix(rng.random((n_p, n_t))),
        "PvsC": sp.csr_matrix(pvsc),
    })
    ds = ACM4Rohe(root=str(tmp_path))
    hg = ds[0]
    assert hg["paper"].x.shape == (n_p, n_t)
    assert set(np.unique(np.asarray(hg["paper"].y))) <= {0, 1, 2}
    m = (np.asarray(hg["paper"].train_mask)
         | np.asarray(hg["paper"].val_mask)
         | np.asarray(hg["paper"].test_mask))
    assert m.all()


def test_addataset_raw(tmp_path):
    from gammagl_tpu.datasets import ADDataset
    rng = np.random.default_rng(0)
    raw = tmp_path / "inj_cora" / "raw"
    raw.mkdir(parents=True)
    n = 10
    np.savez(raw / "inj_cora.npz",
             edge_index=rng.integers(0, n, (2, 30)),
             x=rng.random((n, 5)).astype(np.float32),
             y=(rng.random(n) < 0.1).astype(np.int64))
    ds = ADDataset(root=str(tmp_path), name="inj_cora")
    assert ds[0].x.shape == (n, 5)


def test_alircd_raw(tmp_path):
    from gammagl_tpu.datasets import AliRCD
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    emb = ":".join(f"{v:.4f}" for v in rng.random(256))
    nodes = []
    for i in range(6):
        nodes.append(f"{i},item,{emb}")
    for i in range(6, 10):
        nodes.append(f"{i},user,")  # no embedding -> zeros
    (raw / "AliRCD_session1_nodes.csv").write_text("\n".join(nodes))
    edges = [f"{i + 6},{i},user,item,clicks" for i in range(4)]
    (raw / "AliRCD_session1_edges.csv").write_text("\n".join(edges))
    (raw / "AliRCD_session1_train_labels.csv").write_text(
        "0,1\n1,0\n2,1\n")
    ds = AliRCD(root=str(tmp_path))
    hg = ds[0]
    assert hg["item"].x.shape == (6, 256)
    assert hg[("user", "clicks", "item")].edge_index.shape == (2, 4)
    y = np.asarray(hg["item"].y)
    assert (y[:3] == [1, 0, 1]).all() and (y[3:] == -1).all()


def test_hgb_raw(tmp_path):
    from gammagl_tpu.datasets import HGBDataset
    raw = tmp_path / "acm" / "raw"
    raw.mkdir(parents=True)
    info = {"node.dat": {"node type": {"0": ["paper"], "1": ["author"]}},
            "link.dat": {"link type": {
                "0": {"start": 0, "end": 1, "meaning": "writes"}}}}
    (raw / "info.dat").write_text(json.dumps(info))
    # 4 papers (with 3-dim features) + 3 authors (featureless)
    node_lines = [f"{i}\tp{i}\t0\t0.1,0.2,0.3" for i in range(4)]
    node_lines += [f"{i}\ta{i}\t1" for i in range(4, 7)]
    (raw / "node.dat").write_text("\n".join(node_lines))
    link_lines = [f"{i}\t{4 + i % 3}\t0\t1.0" for i in range(4)]
    (raw / "link.dat").write_text("\n".join(link_lines))
    (raw / "label.dat").write_text("0\tp0\t0\t2\n1\tp1\t0\t1\n")
    (raw / "label.dat.test").write_text("2\tp2\t0\t0\n")
    ds = HGBDataset(root=str(tmp_path), name="acm")
    hg = ds[0]
    assert hg["paper"].x.shape == (4, 3)
    assert hg["author"].num_nodes == 3
    assert hg[("paper", "writes", "author")].edge_index.shape == (2, 4)
    y = np.asarray(hg["paper"].y)
    assert y[0] == 2 and y[2] == 0
    assert np.asarray(hg["paper"].train_mask).sum() == 2
    assert np.asarray(hg["paper"].test_mask).sum() == 1


def test_custom_dataset(tmp_path):
    from gammagl_tpu.data.graph import Graph
    from gammagl_tpu.datasets import CustomDataset
    gs = [Graph(x=np.ones((4, 2), np.float32),
                edge_index=np.asarray([[0, 1], [1, 2]]),
                y=np.asarray([i])) for i in range(3)]
    ds = CustomDataset(gs, root=str(tmp_path / "custom"))
    assert len(ds) == 3
    assert ds[1].x.shape == (4, 2)


def _block_adj(sizes, blocks, rng):
    """Global block adjacency in the IMDB/DBLP processed-zip layout."""
    n = sum(sizes)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    adj = np.zeros((n, n), np.float32)
    for (i, j), m in blocks.items():
        adj[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = m
    return sp.csr_matrix(adj)


def test_imdb_raw(tmp_path):
    """Processed-zip layout of reference gammagl/datasets/imdb.py:
    features_{0,1,2}.npz CSR per node type, labels.npy, split npz,
    adjM.npz block adjacency in movie|director|actor order."""
    from gammagl_tpu.datasets import IMDB
    rng = np.random.default_rng(0)
    raw = tmp_path / "raw"
    raw.mkdir()
    sizes = [5, 3, 4]  # movie, director, actor
    for i, sz in enumerate(sizes):
        sp.save_npz(raw / f"features_{i}.npz",
                    sp.csr_matrix(rng.random((sz, 6)).astype(np.float32)))
    np.save(raw / "labels.npy", rng.integers(0, 3, sizes[0]))
    np.savez(raw / "train_val_test_idx.npz",
             train_idx=np.asarray([0, 1]), val_idx=np.asarray([2]),
             test_idx=np.asarray([3, 4]))
    md = (rng.random((5, 3)) < 0.6).astype(np.float32)
    ma = (rng.random((5, 4)) < 0.6).astype(np.float32)
    adj = _block_adj(sizes, {(0, 1): md, (1, 0): md.T,
                             (0, 2): ma, (2, 0): ma.T}, rng)
    sp.save_npz(raw / "adjM.npz", adj)
    hg = IMDB(root=str(tmp_path))[0]
    assert hg["movie"].x.shape == (5, 6)
    assert hg["actor"].x.shape == (4, 6)
    ei = np.asarray(hg[("movie", "to", "director")].edge_index)
    assert ei.shape[0] == 2 and ei[0].max() < 5 and ei[1].max() < 3
    assert int(md.sum()) == ei.shape[1]
    # symmetric reverse edges present and local-id consistent
    rev = np.asarray(hg[("director", "to", "movie")].edge_index)
    assert rev.shape[1] == ei.shape[1]
    assert np.asarray(hg["movie"].train_mask).sum() == 2
    assert np.asarray(hg["movie"].test_mask).sum() == 2


def test_dblp_raw(tmp_path):
    """DBLP release: 3 featured types + featureless conference block
    inferred from the adjacency tail (reference gammagl/datasets/dblp.py)."""
    from gammagl_tpu.datasets import DBLP
    rng = np.random.default_rng(1)
    raw = tmp_path / "raw"
    raw.mkdir()
    sizes = [4, 5, 3, 2]  # author, paper, term, conference(no feats)
    for i, sz in enumerate(sizes[:3]):
        sp.save_npz(raw / f"features_{i}.npz",
                    sp.csr_matrix(rng.random((sz, 4)).astype(np.float32)))
    np.save(raw / "labels.npy", rng.integers(0, 4, sizes[0]))
    np.savez(raw / "train_val_test_idx.npz",
             train_idx=np.asarray([0]), val_idx=np.asarray([1]),
             test_idx=np.asarray([2, 3]))
    ap = (rng.random((4, 5)) < 0.5).astype(np.float32)
    pc = (rng.random((5, 2)) < 0.5).astype(np.float32)
    adj = _block_adj(sizes, {(0, 1): ap, (1, 0): ap.T,
                             (1, 3): pc, (3, 1): pc.T}, rng)
    sp.save_npz(raw / "adjM.npz", adj)
    hg = DBLP(root=str(tmp_path))[0]
    assert hg["author"].x.shape == (4, 4)
    assert hg["conference"].num_nodes == 2
    ei = np.asarray(hg[("paper", "to", "conference")].edge_index)
    assert ei.shape[1] == int(pc.sum()) and ei[1].max() < 2
    assert np.asarray(hg["author"].y).shape == (4,)

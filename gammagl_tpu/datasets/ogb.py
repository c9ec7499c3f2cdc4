"""OGB node-property datasets (ogbn-arxiv / ogbn-products /
ogbn-papers100M) read from the standard OGB directory layout, staged
offline.

Reference: SURVEY.md §2.4 ("OGB via custom loader") and the reference's
kernel benchmark protocol, which is defined on ogbn-arxiv edge indices
(reference profiler/mpops/complete_test/README.md:11-66). The reference
repo itself has no OGB dataset class — its profiler scripts load
pre-exported edge indices — so this class is the custom loader the
survey calls for, with no download step (this environment has no
egress; stage with `python scripts/stage_data.py check`).

Three accepted raw layouts under ``<root>/<name with _>/raw/``:

1. **npy** (the fast path; what `scripts/stage_data.py`
   converts to): ``node_feat.npy``, ``edge_index.npy``,
   ``node_label.npy`` — loaded with ``mmap_mode='r'`` so a
   papers100M-scale graph costs no resident host RAM until sliced.
2. **npz** (OGB's own large-graph format): ``data.npz`` with
   ``node_feat``/``edge_index`` members plus ``node-label.npz``.
3. **csv.gz** (OGB's small-graph format, e.g. ogbn-arxiv):
   ``node-feat.csv.gz``, ``edge.csv.gz``, ``node-label.csv.gz``.

Split indices from ``<root>/<name with _>/split/<split_type>/
{train,valid,test}.csv.gz`` (or ``.npy``); split_type defaults to the
official per-dataset split (time / sales_ranking).
"""

import gzip
import json
import os
import os.path as osp

import numpy as np

from gammagl_tpu.data.dataset import Dataset
from gammagl_tpu.data.graph import Graph

__all__ = ["OgbNodeDataset"]

_OFFICIAL_SPLIT = {
    "ogbn-arxiv": "time",
    "ogbn-papers100M": "time",
    "ogbn-products": "sales_ranking",
    "ogbn-mag": "time",
    "ogbn-proteins": "species",
}


def _read_csv_gz(path, dtype):
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


class OgbNodeDataset(Dataset):
    """One-graph node-property dataset in OGB's on-disk layout."""

    def __init__(self, root=None, name="ogbn-arxiv", split_type=None,
                 transform=None, to_undirected=False, force_reload=False):
        self.name = name
        self.dir_name = name.replace("-", "_")
        self.split_type = split_type or _OFFICIAL_SPLIT.get(name, "time")
        self.to_undirected = to_undirected
        self._graph = None
        super().__init__(root, transform, force_reload=force_reload)

    # -- paths ---------------------------------------------------------------
    @property
    def raw_dir(self):
        return osp.join(self.root, self.dir_name, "raw")

    @property
    def processed_dir(self):
        return osp.join(self.root, self.dir_name, "processed")

    @property
    def split_dir(self):
        return osp.join(self.root, self.dir_name, "split",
                        self.split_type)

    def _layout(self):
        """Which staged layout is present: 'npy' | 'npz' | 'csv' | None."""
        if osp.exists(osp.join(self.raw_dir, "node_feat.npy")):
            return "npy"
        if osp.exists(osp.join(self.raw_dir, "data.npz")):
            return "npz"
        if osp.exists(osp.join(self.raw_dir, "node-feat.csv.gz")):
            return "csv"
        return None

    @property
    def raw_file_names(self):
        layout = self._layout()
        if layout == "npy":
            return ["node_feat.npy", "edge_index.npy"]
        if layout == "npz":
            return ["data.npz"]
        # canonical csv.gz list — also what an offline host must stage
        return ["node-feat.csv.gz", "edge.csv.gz", "node-label.csv.gz"]

    @property
    def processed_file_names(self):
        return "meta.json"

    def download(self):
        raise RuntimeError(
            f"{self.name} is not staged under {self.raw_dir} and this "
            "host has no download path for OGB archives. Stage the "
            "standard OGB layout (raw/ + split/) or the npy fast path "
            "(node_feat.npy / edge_index.npy / node_label.npy); see "
            "scripts/stage_data.py.")

    # -- processing ----------------------------------------------------------
    def process(self):
        """csv.gz layouts are converted once to the mmap-able npy fast
        path; npy/npz layouts are used in place. Only a meta marker is
        written — a papers100M-scale graph is never pickled."""
        layout = self._layout()
        if layout == "csv":
            x = _read_csv_gz(osp.join(self.raw_dir, "node-feat.csv.gz"),
                             np.float32)
            ei = _read_csv_gz(osp.join(self.raw_dir, "edge.csv.gz"),
                              np.int64).T
            np.save(osp.join(self.raw_dir, "node_feat.npy"), x)
            np.save(osp.join(self.raw_dir, "edge_index.npy"),
                    np.ascontiguousarray(ei))
            lbl = osp.join(self.raw_dir, "node-label.csv.gz")
            if osp.exists(lbl):
                np.save(osp.join(self.raw_dir, "node_label.npy"),
                        _read_csv_gz(lbl, np.float64).ravel())
        with open(self.processed_paths[0], "w") as f:
            json.dump({"name": self.name, "layout": self._layout()}, f)

    # -- access --------------------------------------------------------------
    def _load_graph(self):
        layout = self._layout()
        if layout == "npz":
            d = np.load(osp.join(self.raw_dir, "data.npz"))
            x = d[[k for k in d.files if "feat" in k][0]]
            ei = d[[k for k in d.files
                    if "edge" in k and "index" in k][0]]
            y = None
            lblf = osp.join(self.raw_dir, "node-label.npz")
            if osp.exists(lblf):
                lbl = np.load(lblf)
                y = lbl[lbl.files[0]].ravel()
        else:  # npy fast path (csv was converted by process())
            x = np.load(osp.join(self.raw_dir, "node_feat.npy"),
                        mmap_mode="r")
            ei = np.load(osp.join(self.raw_dir, "edge_index.npy"),
                         mmap_mode="r")
            y = None
            lblf = osp.join(self.raw_dir, "node_label.npy")
            if osp.exists(lblf):
                y = np.load(lblf, mmap_mode="r")
        if ei.shape[0] != 2:
            ei = ei.T
        if self.to_undirected:
            ei = np.concatenate([np.asarray(ei), np.asarray(ei)[::-1]],
                                axis=1)
        g = Graph(x=x, edge_index=ei)
        n = x.shape[0]
        if y is not None:
            yy = np.asarray(y)
            g.y = np.where(np.isnan(yy), -1, yy).astype(np.int64)
        for split, attr in (("train", "train_idx"), ("valid", "val_idx"),
                            ("test", "test_idx")):
            idx = self._split_idx(split)
            if idx is not None:
                setattr(g, attr, idx)
                mask = np.zeros(n, bool)
                mask[idx] = True
                setattr(g, attr.replace("idx", "mask"), mask)
        return g

    def _split_idx(self, split):
        npy = osp.join(self.split_dir, f"{split}.npy")
        if osp.exists(npy):
            return np.load(npy)
        csv = osp.join(self.split_dir, f"{split}.csv.gz")
        if osp.exists(csv):
            return _read_csv_gz(csv, np.int64).ravel()
        return None

    def len(self):
        return 1

    def get(self, idx):
        assert idx == 0
        if self._graph is None:
            self._graph = self._load_graph()
        return self._graph

    @property
    def num_classes(self):
        g = self[0]
        if "y" not in g:
            return 0
        return int(np.asarray(g.y).max()) + 1

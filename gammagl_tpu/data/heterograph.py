"""HeteroGraph: typed node/edge stores, as a JAX pytree.

Reference: gammagl/data/heterograph.py:20 -- node stores keyed by node-type
string, edge stores keyed by (src_type, relation, dst_type) triples, with
`metadata()`, `to_homogeneous()`, and the same batching protocol per store.
"""

from typing import Dict, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from gammagl_tpu.data.graph import BaseGraph, _is_array

__all__ = ["HeteroGraph"]

EdgeTypeKey = Union[str, Tuple[str, str, str]]


class _Store(BaseGraph):
    """One node-type or edge-type storage (reference storage.py NodeStorage /
    EdgeStorage)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        object.__setattr__(self, "_num_nodes", None)

    @property
    def num_nodes(self):
        if self._num_nodes is not None:
            return self._num_nodes
        x = self._store.get("x")
        if x is not None:
            return int(x.shape[0])
        return None

    @num_nodes.setter
    def num_nodes(self, v):
        object.__setattr__(self, "_num_nodes", v)

    @property
    def num_edges(self):
        ei = self._store.get("edge_index")
        return int(ei.shape[1]) if ei is not None else 0


def _norm_edge_key(key):
    if isinstance(key, tuple):
        if len(key) == 3:
            return tuple(key)
        if len(key) == 2:
            return (key[0], "to", key[1])
    return key


class HeteroGraph:
    """Dict-of-stores heterogeneous graph.

    g['paper'].x = ...; g[('paper','cites','paper')].edge_index = ...
    """

    def __init__(self, mapping=None, **kwargs):
        object.__setattr__(self, "_node_stores", {})
        object.__setattr__(self, "_edge_stores", {})
        object.__setattr__(self, "_globals", {})
        if mapping:
            for k, v in mapping.items():
                for a, b in v.items():
                    self[k][a] = b
        for k, v in kwargs.items():
            for a, b in v.items():
                self[k][a] = b

    def __setitem__(self, key, value):
        """Graph-level attribute (reference heterograph stores e.g. nested
        train/val/test sub-HeteroGraphs: datasets/acm4dhn.py)."""
        self._globals[key] = value

    def __getitem__(self, key) -> _Store:
        if not isinstance(key, tuple) and key in self._globals:
            return self._globals[key]
        key = _norm_edge_key(key)
        if isinstance(key, tuple):
            if key not in self._edge_stores:
                self._edge_stores[key] = _Store()
            return self._edge_stores[key]
        if key not in self._node_stores:
            self._node_stores[key] = _Store()
        return self._node_stores[key]

    def __contains__(self, key):
        key = _norm_edge_key(key)
        return (key in self._edge_stores if isinstance(key, tuple)
                else key in self._node_stores)

    def __getattr__(self, key):
        if key.endswith("_dict"):
            attr = key[:-5]
            out = {}
            for k, s in list(self._node_stores.items()) + list(
                    self._edge_stores.items()):
                if attr in s:
                    out[k] = s[attr]
            return out
        raise AttributeError(key)

    # -- introspection (reference heterograph.py:402-494) -------------------
    @property
    def node_types(self):
        return list(self._node_stores.keys())

    @property
    def edge_types(self):
        return list(self._edge_stores.keys())

    def metadata(self):
        return self.node_types, self.edge_types

    def node_items(self):
        return list(self._node_stores.items())

    def edge_items(self):
        return list(self._edge_stores.items())

    def get_node_store(self, key):
        return self[key]

    def get_edge_store(self, src, rel, dst):
        return self[(src, rel, dst)]

    @property
    def num_nodes(self):
        sizes = [s.num_nodes for s in self._node_stores.values()]
        return sum(v for v in sizes if v is not None)

    @property
    def num_edges(self):
        return sum(s.num_edges for s in self._edge_stores.values())

    def to_homogeneous(self, node_attrs=("x",), add_node_type=True,
                       add_edge_type=True):
        """Merge typed stores into one Graph with node_type / edge_type vectors
        (reference heterograph.py:494)."""
        from gammagl_tpu.data.graph import Graph
        offsets, cursor = {}, 0
        ntypes = self.node_types
        for nt in ntypes:
            offsets[nt] = cursor
            cursor += self[nt].num_nodes or 0
        num_nodes = cursor
        node_type = np.zeros(num_nodes, np.int64)
        for i, nt in enumerate(ntypes):
            n = self[nt].num_nodes or 0
            node_type[offsets[nt]:offsets[nt] + n] = i
        eis, etypes = [], []
        for j, (et, store) in enumerate(self.edge_items()):
            ei = np.asarray(store.edge_index)
            ei = np.stack([ei[0] + offsets[et[0]], ei[1] + offsets[et[2]]])
            eis.append(ei)
            etypes.append(np.full(ei.shape[1], j, np.int64))
        g = Graph(num_nodes=num_nodes)
        if eis:
            g.edge_index = np.concatenate(eis, axis=1)
            if add_edge_type:
                g.edge_type = np.concatenate(etypes)
        if add_node_type:
            g.node_type = node_type
        xs = [np.asarray(self[nt].x) for nt in ntypes
              if "x" in self[nt]]
        if len(xs) == len(ntypes) and xs and all(
                x.shape[1:] == xs[0].shape[1:] for x in xs):
            g.x = np.concatenate(xs, axis=0)
        return g

    def tensor(self):
        for s in list(self._node_stores.values()) + list(
                self._edge_stores.values()):
            for k, v in s.items():
                if _is_array(v):
                    s[k] = jnp.asarray(v)
        return self

    def numpy(self):
        for s in list(self._node_stores.values()) + list(
                self._edge_stores.values()):
            for k, v in s.items():
                if _is_array(v):
                    s[k] = np.asarray(v)
        return self

    def __repr__(self):
        parts = []
        for nt, s in self._node_stores.items():
            parts.append(f"{nt}: {dict((k, getattr(v, 'shape', v)) for k, v in s.items())}")
        for et, s in self._edge_stores.items():
            parts.append(f"{et}: E={s.num_edges}")
        return "HeteroGraph(\n  " + "\n  ".join(parts) + "\n)"


def _hg_flatten(g: HeteroGraph):
    nkeys = sorted(g._node_stores.keys())
    ekeys = sorted(g._edge_stores.keys())
    children = []
    spec = []
    for k in nkeys:
        s = g._node_stores[k]
        skeys = sorted(s._store.keys())
        children.extend(s._store[a] for a in skeys)
        spec.append((k, tuple(skeys), s._num_nodes))
    espec = []
    for k in ekeys:
        s = g._edge_stores[k]
        skeys = sorted(s._store.keys())
        children.extend(s._store[a] for a in skeys)
        espec.append((k, tuple(skeys)))
    return children, (tuple(spec), tuple(espec))


def _hg_unflatten(aux, children):
    spec, espec = aux
    g = HeteroGraph()
    it = iter(children)
    for k, skeys, nn in spec:
        s = g[k]
        for a in skeys:
            s[a] = next(it)
        s.num_nodes = nn
    for k, skeys in espec:
        s = g[k]
        for a in skeys:
            s[a] = next(it)
    return g


jax.tree_util.register_pytree_node(HeteroGraph, _hg_flatten, _hg_unflatten)

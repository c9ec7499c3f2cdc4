"""Graph: the core homogeneous graph container, as a JAX pytree.

A re-design of the reference's dict-backed eager `Graph`
(gammagl/data/graph.py:31,358): attributes live in one flat mapping and the
whole object is a registered pytree, so a `Graph` flows through `jit`,
`grad`, `vmap`, and `shard_map` directly. Shapes are static per instance --
the padding/bucketing utilities (`gammagl_tpu.data.padding`) produce
fixed-shape graphs so XLA compiles once per bucket.

The `__cat_dim__` / `__inc__` batching protocol (reference graph.py:85-107)
is kept verbatim in spirit: `Batch.from_data_list` uses the same offset
algebra.
"""

import copy as _copy
from typing import Any, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["Graph", "BaseGraph"]


def _is_array(v):
    return isinstance(v, (jax.Array, np.ndarray))


class BaseGraph:
    """Shared attribute-mapping behavior for Graph / HeteroGraph stores."""

    def __init__(self, **kwargs):
        self._store: Dict[str, Any] = {}
        for k, v in kwargs.items():
            if v is not None:
                self._store[k] = v

    # -- mapping protocol ---------------------------------------------------
    def __getattr__(self, key):
        store = self.__dict__.get("_store")
        if store is not None and key in store:
            return store[key]
        raise AttributeError(key)

    def __setattr__(self, key, value):
        if key.startswith("_") or key == "num_nodes":
            object.__setattr__(self, key, value)
        else:
            self._store[key] = value

    def __getitem__(self, key):
        return self._store[key]

    def __setitem__(self, key, value):
        self._store[key] = value

    def __delitem__(self, key):
        del self._store[key]

    def __contains__(self, key):
        return key in self._store

    def keys(self):
        return self._store.keys()

    def items(self):
        return self._store.items()

    def values(self):
        return self._store.values()

    def to_dict(self):
        return dict(self._store)


class Graph(BaseGraph):
    """Homogeneous graph: `x` (N, F) node features, `edge_index` (2, E) COO
    src/dst rows, plus arbitrary named attributes.

    Parameters mirror the reference `Graph` (gammagl/data/graph.py:358):
    x, edge_index, edge_attr/edge_weight, y, plus any kwargs.
    """

    def __init__(self, x=None, edge_index=None, edge_attr=None, y=None,
                 num_nodes=None, **kwargs):
        super().__init__(x=x, edge_index=edge_index, edge_attr=edge_attr,
                         y=y, **kwargs)
        object.__setattr__(self, "_num_nodes", num_nodes)

    # -- sizes --------------------------------------------------------------
    @property
    def num_nodes(self):
        if self._num_nodes is not None:
            return self._num_nodes
        x = self._store.get("x")
        if x is not None:
            return int(x.shape[0])
        ei = self._store.get("edge_index")
        if ei is not None:
            return int(np.asarray(ei).max()) + 1
        return None

    @num_nodes.setter
    def num_nodes(self, v):
        object.__setattr__(self, "_num_nodes", v)

    @property
    def num_edges(self):
        ei = self._store.get("edge_index")
        return int(ei.shape[1]) if ei is not None else 0

    @property
    def num_node_features(self):
        x = self._store.get("x")
        return int(x.shape[-1]) if x is not None else 0

    num_features = num_node_features

    @property
    def num_edge_features(self):
        ea = self._store.get("edge_attr")
        return int(ea.shape[-1]) if ea is not None and ea.ndim > 1 else 0

    # -- degree (reference graph.py:557-575) --------------------------------
    @property
    def in_degree(self):
        from gammagl_tpu.utils.degree import degree
        return degree(jnp.asarray(self.edge_index[1]), self.num_nodes)

    @property
    def out_degree(self):
        from gammagl_tpu.utils.degree import degree
        return degree(jnp.asarray(self.edge_index[0]), self.num_nodes)

    # -- batching protocol (reference graph.py:85-107) ----------------------
    def __cat_dim__(self, key, value=None):
        if key == "edge_index":
            return 1
        return 0

    def __inc__(self, key, value=None):
        if key == "edge_index":
            return self.num_nodes
        if "index" in key or key == "face":
            return self.num_nodes
        return 0

    # -- graph ops ----------------------------------------------------------
    def add_self_loop(self, n_loops=1):
        """Reference: gammagl/data/graph.py:577."""
        from gammagl_tpu.utils.loop import add_self_loops
        ei, ea = add_self_loops(self.edge_index,
                                self._store.get("edge_attr"),
                                num_nodes=self.num_nodes, n_loops=n_loops)
        g = self.clone()
        g.edge_index = ei
        if ea is not None:
            g.edge_attr = ea
        return g

    def sorted_edges(self, sort_by="dst"):
        """Reference: gammagl/data/graph.py:592."""
        ei = np.asarray(self.edge_index)
        key = ei[1] if sort_by == "dst" else ei[0]
        perm = np.argsort(key, kind="stable")
        return ei[:, perm], perm

    # -- conversion (reference graph.py:616,649) ----------------------------
    def tensor(self):
        """Move array attrs onto device (jnp)."""
        g = self.clone()
        for k, v in g.items():
            if _is_array(v):
                g[k] = jnp.asarray(v)
        return g

    def numpy(self):
        g = self.clone()
        for k, v in g.items():
            if _is_array(v):
                g[k] = np.asarray(v)
        return g

    def clone(self):
        g = self.__class__()
        g._store = dict(self._store)
        object.__setattr__(g, "_num_nodes", self._num_nodes)
        return g

    def copy(self):
        return self.clone()

    def deepcopy(self):
        g = self.__class__()
        g._store = _copy.deepcopy(self._store)
        object.__setattr__(g, "_num_nodes", self._num_nodes)
        return g

    def to_heterogeneous(self, node_type=None, edge_type=None,
                         node_type_names=None, edge_type_names=None):
        """Reference: gammagl/data/graph.py:683."""
        from gammagl_tpu.data.heterograph import HeteroGraph
        ei = np.asarray(self.edge_index)
        node_type = np.zeros(self.num_nodes, np.int64) if node_type is None \
            else np.asarray(node_type)
        edge_type = np.zeros(self.num_edges, np.int64) if edge_type is None \
            else np.asarray(edge_type)
        ntypes = node_type_names or [str(i) for i in
                                     range(int(node_type.max()) + 1)]
        out = HeteroGraph()
        local = np.zeros(self.num_nodes, np.int64)
        for i, nt in enumerate(ntypes):
            mask = node_type == i
            local[mask] = np.arange(mask.sum())
            if "x" in self:
                out[nt].x = np.asarray(self.x)[mask]
            out[nt].num_nodes = int(mask.sum())
        n_et = int(edge_type.max()) + 1 if len(edge_type) else 0
        for j in range(n_et):
            mask = edge_type == j
            sub = ei[:, mask]
            st = ntypes[int(node_type[sub[0, 0]])] if sub.size else ntypes[0]
            dt = ntypes[int(node_type[sub[1, 0]])] if sub.size else ntypes[0]
            name = (edge_type_names[j] if edge_type_names
                    else (st, f"e{j}", dt))
            out[name].edge_index = local[sub]
        return out

    def dump(self, path):
        """Pickle to disk (reference graph.py:886)."""
        import pickle
        with open(path, "wb") as f:
            pickle.dump(self.numpy(), f)

    @staticmethod
    def load(path):
        import pickle
        with open(path, "rb") as f:
            return pickle.load(f)

    def __repr__(self):
        fields = []
        for k, v in self._store.items():
            if _is_array(v):
                fields.append(f"{k}={list(v.shape)}")
            else:
                fields.append(f"{k}={v}")
        return f"{self.__class__.__name__}({', '.join(fields)})"


def _graph_flatten(g: Graph):
    keys = sorted(g._store.keys())
    children = [g._store[k] for k in keys]
    aux = (tuple(keys), g._num_nodes)
    return children, aux


def _graph_unflatten(aux, children):
    keys, num_nodes = aux
    g = Graph(num_nodes=num_nodes)
    g._store = dict(zip(keys, children))
    return g


jax.tree_util.register_pytree_node(Graph, _graph_flatten, _graph_unflatten)

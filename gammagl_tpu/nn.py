"""A small module system with `flax.linen`'s interface.

The package's layers and models are written against the subset of
`flax.linen` defined here: `Module` (dataclass fields, `compact` and `setup`
styles, `param`, `variable`, `make_rng`, `init`, `apply`), `Dense`,
`Dropout`, `LayerNorm`, `Embed`, `Sequential`, `Conv`, `max_pool`,
`SelfAttention`, `initializers` and the activations of `jax.nn`. Variables
use flax's tree layout and names (`{"params": {"Dense_0": {"kernel": ...}}}`,
attribute names for `setup` children and module-valued fields), so a params
tree reads the same as one made by flax. Only `jax` is needed.

Parameters are looked up by module path: calling the same submodule twice,
or a parent's compact method twice, reuses one set of parameters.
Initial values come from `fold_in(rngs["params"], crc32(path))`, so they
differ from flax's draws for the same seed.
"""

import dataclasses
import functools
import inspect
import math
import threading
import zlib
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.nn import (elu, gelu, leaky_relu, log_sigmoid, one_hot,  # noqa: F401
                    relu, sigmoid, softmax, softplus, tanh)
from jax.nn import initializers  # noqa: F401

__all__ = ["Module", "compact", "Variable", "Dense", "DenseGeneral",
           "Dropout", "LayerNorm", "Embed", "Sequential", "Conv", "max_pool",
           "SelfAttention", "make_causal_mask", "initializers"]

_UNSPECIFIED = object()


class _Context(threading.local):
    def __init__(self):
        self.stack = [None]


_ctx = _Context()


def compact(fn):
    """Marks the method in which submodules are defined inline."""
    fn._compact = True
    return fn


def _path_hash(path):
    return zlib.crc32("/".join(path).encode()) & 0x7FFFFFFF


class _Root:
    """State shared by every module bound in one `init` or `apply` call."""

    def __init__(self, variables, rngs, mutable, initializing,
                 capture=None):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.capture = capture
        self.rng_counts = {}

    def is_mutable(self, col):
        m = self.mutable
        if isinstance(m, bool):
            return m
        if isinstance(m, str):
            return m == col
        return col in m

    def get(self, col, path, name):
        d = self.variables.get(col)
        for p in path:
            if d is None:
                return None
            d = d.get(p)
        return None if d is None else d.get(name)

    def put(self, col, path, name, value):
        if not self.is_mutable(col):
            raise ValueError(f"collection {col!r} is not mutable; pass "
                             f"mutable=[{col!r}] to apply")
        d = self.variables.setdefault(col, {})
        for p in path:
            d = d.setdefault(p, {})
        d[name] = value

    def make_rng(self, name, path):
        if name not in self.rngs:
            if "params" not in self.rngs:
                raise ValueError(f"no rng stream {name!r}: pass "
                                 f"rngs={{{name!r}: key}}")
            name = "params"
        count = self.rng_counts.get((name, path), 0)
        self.rng_counts[(name, path)] = count + 1
        key = jax.random.fold_in(self.rngs[name], _path_hash(path))
        return jax.random.fold_in(key, count)


class Variable:
    """A mutable variable of a non-param collection (`Module.variable`)."""

    def __init__(self, root, col, path, name):
        self._root, self._col, self._path, self._name = root, col, path, name

    @property
    def value(self):
        return self._root.get(self._col, self._path, self._name)

    @value.setter
    def value(self, v):
        self._root.put(self._col, self._path, self._name, v)


class _State:
    def __init__(self):
        self.autoname = {}
        self.depth = 0
        self.in_setup = False
        self.setup_done = False


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


def _map_modules(value, fn, suffix=""):
    """Rebuild `value` with `fn(module, suffix)` applied to every module in
    (possibly nested) lists, tuples and dicts; suffix follows flax's names
    (`attr_0`, `attr_key`)."""
    if isinstance(value, Module):
        return fn(value, suffix)
    if isinstance(value, (list, tuple)):
        out = [_map_modules(v, fn, f"{suffix}_{i}")
               for i, v in enumerate(value)]
        return type(value)(out) if isinstance(value, tuple) else out
    if isinstance(value, dict):
        return {k: _map_modules(v, fn, f"{suffix}_{k}")
                for k, v in value.items()}
    return value


_NOT_WRAPPED = {"__init__", "__post_init__", "__getattr__", "__setattr__",
                "__repr__", "__eq__", "__hash__", "__init_subclass__",
                "setup"}


def _wrap_method(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._root is None:
            return fn(self, *args, **kwargs)
        self._try_setup()
        state = self._state
        _ctx.stack.append(self)
        state.depth += 1
        try:
            out = fn(self, *args, **kwargs)
        finally:
            state.depth -= 1
            _ctx.stack.pop()
            if state.depth == 0:
                state.autoname = {}
        capture = self._root.capture
        if capture is not None and capture(self, fn.__name__):
            prev = self._root.get("intermediates", self._path, fn.__name__)
            self._root.put("intermediates", self._path, fn.__name__,
                           (prev or ()) + (out,))
        return out
    return wrapped


class Module:
    """Base class of layers and models (the `flax.linen.Module` subset).

    Subclasses are dataclasses. A module built inside another's `compact`
    method or `setup` becomes its child; one passed in as a field is
    adopted under the field's name when the holder is bound.
    """

    _root = None
    _path = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if "name" not in getattr(cls, "__dataclass_fields__", {}):
            ann = dict(cls.__dict__.get("__annotations__", {}))
            ann["parent"] = Any
            ann["name"] = Optional[str]
            cls.__annotations__ = ann
            cls.parent = dataclasses.field(default=_UNSPECIFIED,
                                           kw_only=True, repr=False)
            cls.name = dataclasses.field(default=None, kw_only=True)
        fields = cls.__dict__.get("__annotations__", {})
        for attr, val in list(cls.__dict__.items()):
            if (inspect.isfunction(val) and attr not in fields
                    and attr not in _NOT_WRAPPED
                    and not getattr(val, "_module_wrapped", False)):
                w = _wrap_method(val)
                w._module_wrapped = True
                setattr(cls, attr, w)
        dataclasses.dataclass(cls, eq=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_state", _State())
        if self.parent is _UNSPECIFIED:
            object.__setattr__(self, "parent", _ctx.stack[-1])
        parent = self.parent
        if isinstance(parent, Module) and parent._root is not None:
            if self.name is None:
                if parent._state.in_setup:
                    return  # named when assigned to an attribute
                prefix = type(self).__name__
                n = parent._state.autoname.get(prefix, 0)
                parent._state.autoname[prefix] = n + 1
                object.__setattr__(self, "name", f"{prefix}_{n}")
            self._bind(parent._root, parent._path + (self.name,))

    def __repr__(self):
        fields = ", ".join(
            f"{f.name}={getattr(self, f.name, None)!r}"
            for f in dataclasses.fields(self) if f.name != "parent")
        return f"{type(self).__name__}({fields})"

    def _bind(self, root, path):
        object.__setattr__(self, "_root", root)
        object.__setattr__(self, "_path", path)
        adopted = {}

        def adopt(m, suffix, field):
            if m._root is not None:
                return m  # already a child of the module that built it
            if id(m) not in adopted:
                adopted[id(m)] = m.clone(parent=self, name=field + suffix)
            return adopted[id(m)]

        for f in dataclasses.fields(self):
            if f.name in ("parent", "name"):
                continue
            val = getattr(self, f.name)
            new = _map_modules(
                val, lambda m, s, f=f.name: adopt(m, s, f))
            if new is not val:
                object.__setattr__(self, f.name, new)

    def __setattr__(self, attr, value):
        state = self.__dict__.get("_state")
        if state is not None and state.in_setup:
            def attach(m, suffix):
                if m.parent is None or (m.parent is self and m._root is None):
                    if m.parent is None:
                        m = m.clone(parent=self, name=attr + suffix)
                    else:
                        object.__setattr__(m, "name", attr + suffix)
                        m._bind(self._root, self._path + (m.name,))
                return m
            value = _map_modules(value, attach)
        object.__setattr__(self, attr, value)

    def __getattr__(self, attr):
        state = self.__dict__.get("_state")
        if (state is not None and self.__dict__.get("_root") is not None
                and not state.setup_done and not attr.startswith("__")):
            self._try_setup()
            return object.__getattribute__(self, attr)
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {attr!r}")

    def _try_setup(self):
        state = self._state
        if state.setup_done or state.in_setup:
            return
        state.in_setup = True
        _ctx.stack.append(self)
        try:
            self.setup()
        finally:
            _ctx.stack.pop()
            state.in_setup = False
        state.setup_done = True

    def setup(self):
        """Define submodules and parameters eagerly (override)."""

    def clone(self, **updates):
        """An unbound copy with `updates` applied to its fields."""
        updates.setdefault("parent", None)
        return dataclasses.replace(self, **updates)

    # -- variables ------------------------------------------------------
    def _require_bound(self):
        if self._root is None:
            raise ValueError(f"{type(self).__name__} is not bound: call it "
                             "through init/apply or from a parent module")

    def param(self, name, init_fn, *init_args, **init_kwargs):
        """The parameter `name` of this module; created during `init` as
        `init_fn(key, *init_args, **init_kwargs)`."""
        self._require_bound()
        value = self._root.get("params", self._path, name)
        if value is None:
            if not self._root.is_mutable("params"):
                raise ValueError(f"missing parameter {'/'.join(self._path)}"
                                 f"/{name}")
            key = jax.random.fold_in(self._root.rngs["params"],
                                     _path_hash(self._path + (name,)))
            value = init_fn(key, *init_args, **init_kwargs)
            self._root.put("params", self._path, name, value)
        return value

    def variable(self, col, name, init_fn=None, *init_args, **init_kwargs):
        """A `Variable` of collection `col`, created from `init_fn(*args)`
        when missing and `col` is mutable."""
        self._require_bound()
        if self._root.get(col, self._path, name) is None:
            if init_fn is None or not self._root.is_mutable(col):
                raise ValueError(f"missing variable {col}/"
                                 f"{'/'.join(self._path)}/{name}")
            self._root.put(col, self._path, name,
                           init_fn(*init_args, **init_kwargs))
        return Variable(self._root, col, self._path, name)

    def make_rng(self, name="params"):
        """A fresh key from the `name` stream (falls back to `params`)."""
        self._require_bound()
        return self._root.make_rng(name, self._path)

    def is_initializing(self):
        """True inside `init`."""
        self._require_bound()
        return self._root.initializing

    # -- entry points ---------------------------------------------------
    def _run(self, root, method, args, kwargs):
        bound = self.clone(parent=None)
        bound._bind(root, ())
        if method is None:
            fn = bound.__call__
        elif isinstance(method, str):
            fn = getattr(bound, method)
        else:
            fn = functools.partial(method, bound)
        return fn(*args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs):
        """Returns the variables (`{"params": ...}`, plus any other
        collection the module creates)."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        root = _Root({}, rngs, True, True)
        self._run(root, method, args, kwargs)
        return root.variables

    def apply(self, variables, *args, rngs=None, method=None, mutable=False,
              capture_intermediates=False, **kwargs):
        """Runs `method` (default `__call__`) with `variables`. With
        `mutable` (a collection name, a list of them, or True) or
        `capture_intermediates`, returns `(out, updated_collections)`."""
        if rngs is not None and not isinstance(rngs, dict):
            rngs = {"params": rngs}
        capture = _capture_fn(capture_intermediates)
        if capture is not None:
            if mutable is False:
                mutable = ["intermediates"]
            elif isinstance(mutable, (list, tuple)):
                mutable = list(mutable) + ["intermediates"]
            elif isinstance(mutable, str):
                mutable = [mutable, "intermediates"]
        root = _Root(_copy_dicts(dict(variables)), dict(rngs or {}), mutable,
                     False, capture)
        out = self._run(root, method, args, kwargs)
        if mutable is False:
            return out
        return out, {c: v for c, v in root.variables.items()
                     if root.is_mutable(c)}


def _capture_fn(capture):
    if capture is True:
        return lambda mdl, name: name == "__call__"
    return capture or None


# -- layers -----------------------------------------------------------------

def _promote(dtype, *xs):
    dtype = dtype or jnp.result_type(*[x for x in xs if x is not None])
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


class Dense(Module):
    """`y = x @ kernel + bias` (params `kernel` (in, features), `bias`)."""

    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(inputs)[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(self.dtype, inputs, kernel, bias)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())),
                            precision=self.precision)
        if bias is not None:
            y = y + bias
        return y


class DenseGeneral(Module):
    """Dense over several input axes to several output axes."""

    features: Any
    axis: Any = -1
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        features = ((self.features,) if isinstance(self.features, int)
                    else tuple(self.features))
        axis = (self.axis,) if isinstance(self.axis, int) else tuple(self.axis)
        axis = tuple(a % inputs.ndim for a in axis)
        in_shape = tuple(inputs.shape[a] for a in axis)
        n_in, n_out = math.prod(in_shape), math.prod(features)

        def kernel_init(rng, shape, dtype):
            flat = self.kernel_init(rng, (n_in, n_out), dtype)
            return jnp.reshape(flat, shape)

        def bias_init(rng, shape, dtype):
            return jnp.reshape(self.bias_init(rng, (n_out,), dtype), shape)

        kernel = self.param("kernel", kernel_init, in_shape + features,
                            self.param_dtype)
        bias = (self.param("bias", bias_init, features, self.param_dtype)
                if self.use_bias else None)
        inputs, kernel, bias = _promote(self.dtype, inputs, kernel, bias)
        y = lax.dot_general(
            inputs, kernel, ((axis, tuple(range(len(axis)))), ((), ())),
            precision=self.precision)
        if bias is not None:
            y = y + bias
        return y


class Dropout(Module):
    """Inverted dropout drawing from the `dropout` rng stream."""

    rate: float
    broadcast_dims: Sequence[int] = ()
    deterministic: Optional[bool] = None
    rng_collection: str = "dropout"

    @compact
    def __call__(self, inputs, deterministic=None, rng=None):
        deterministic = (self.deterministic if deterministic is None
                         else deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        if self.rate == 1.0:
            return jnp.zeros_like(inputs)
        keep = 1.0 - self.rate
        if rng is None:
            rng = self.make_rng(self.rng_collection)
        shape = list(jnp.shape(inputs))
        for d in self.broadcast_dims:
            shape[d] = 1
        mask = jax.random.bernoulli(rng, keep, shape)
        mask = jnp.broadcast_to(mask, jnp.shape(inputs))
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))


class LayerNorm(Module):
    """Layer normalisation over the last axis (params `scale`, `bias`)."""

    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x):
        feat = (jnp.shape(x)[-1],)
        x32 = jnp.asarray(x, jnp.promote_types(x.dtype, jnp.float32))
        mean = x32.mean(-1, keepdims=True)
        var = jnp.maximum(0.0, (x32 * x32).mean(-1, keepdims=True)
                          - mean * mean)
        y = (x32 - mean) * lax.rsqrt(var + self.epsilon)
        args = [x]
        if self.use_scale:
            scale = self.param("scale", self.scale_init, feat,
                               self.param_dtype)
            y = y * scale
            args.append(scale)
        if self.use_bias:
            bias = self.param("bias", self.bias_init, feat, self.param_dtype)
            y = y + bias
            args.append(bias)
        return jnp.asarray(y, self.dtype or jnp.result_type(*args))


class Embed(Module):
    """Embedding table lookup (param `embedding` (num, features))."""

    num_embeddings: int
    features: int
    dtype: Any = None
    param_dtype: Any = jnp.float32
    embedding_init: Callable = initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0)

    def setup(self):
        self.embedding = self.param(
            "embedding", self.embedding_init,
            (self.num_embeddings, self.features), self.param_dtype)

    def __call__(self, inputs):
        if not jnp.issubdtype(jnp.asarray(inputs).dtype, jnp.integer):
            raise ValueError("Embed input must be integers")
        (emb,) = _promote(self.dtype, self.embedding)
        return jnp.take(emb, inputs, axis=0)

    def attend(self, query):
        query, emb = _promote(self.dtype, query, self.embedding)
        return query @ emb.T


class Sequential(Module):
    """Applies `layers` in order; a tuple output feeds the next as *args."""

    layers: Sequence[Callable]

    def __call__(self, *args, **kwargs):
        if not self.layers:
            raise ValueError("empty Sequential")
        out = self.layers[0](*args, **kwargs)
        for layer in self.layers[1:]:
            if isinstance(out, tuple):
                out = layer(*out)
            elif isinstance(out, dict):
                out = layer(**out)
            else:
                out = layer(out)
        return out


class Conv(Module):
    """Convolution over the spatial axes of (batch, *spatial, features)
    input (params `kernel` (*kernel_size, in, features), `bias`)."""

    features: int
    kernel_size: Sequence[int]
    strides: Any = 1
    padding: Any = "SAME"
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs):
        ks = tuple(self.kernel_size)
        nd = len(ks)
        strides = ((self.strides,) * nd if isinstance(self.strides, int)
                   else tuple(self.strides))
        kernel = self.param("kernel", self.kernel_init,
                            ks + (inputs.shape[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(self.dtype, inputs, kernel, bias)
        sp = "HWD"[:nd] if nd <= 3 else None
        y = lax.conv_general_dilated(
            inputs, kernel, strides, self.padding,
            dimension_numbers=("N" + sp + "C", sp + "IO", "N" + sp + "C"))
        if bias is not None:
            y = y + bias
        return y


def max_pool(inputs, window_shape, strides=None, padding="VALID"):
    """Max over windows of the spatial axes of (batch, *spatial, C)."""
    window_shape = tuple(window_shape)
    strides = tuple(strides) if strides is not None else (1,) * len(
        window_shape)
    init = (-jnp.inf if jnp.issubdtype(inputs.dtype, jnp.floating)
            else jnp.iinfo(inputs.dtype).min)
    return lax.reduce_window(inputs, jnp.asarray(init, inputs.dtype),
                             lax.max, (1,) + window_shape + (1,),
                             (1,) + strides + (1,), padding)


def make_causal_mask(x, dtype=jnp.float32):
    """(…, 1, L, L) mask letting position i attend to positions <= i."""
    idxs = jnp.broadcast_to(jnp.arange(x.shape[-1], dtype=jnp.int32),
                            x.shape)
    mask = jnp.greater_equal(idxs[..., :, None], idxs[..., None, :])
    return jnp.expand_dims(mask, -3).astype(dtype)


class SelfAttention(Module):
    """Multi-head self-attention with `query`/`key`/`value`/`out`
    projections."""

    num_heads: int
    qkv_features: Optional[int] = None
    out_features: Optional[int] = None
    dropout_rate: float = 0.0
    deterministic: Optional[bool] = None
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs_q, mask=None, deterministic=None):
        features = self.out_features or inputs_q.shape[-1]
        qkv = self.qkv_features or inputs_q.shape[-1]
        if qkv % self.num_heads:
            raise ValueError("qkv_features must divide by num_heads")
        head_dim = qkv // self.num_heads

        def proj(name):
            return DenseGeneral((self.num_heads, head_dim), axis=-1,
                                use_bias=self.use_bias, dtype=self.dtype,
                                param_dtype=self.param_dtype,
                                kernel_init=self.kernel_init,
                                bias_init=self.bias_init, name=name)

        q = proj("query")(inputs_q) / math.sqrt(head_dim)
        k = proj("key")(inputs_q)
        v = proj("value")(inputs_q)
        logits = jnp.einsum("...qhd,...khd->...hqk", q, k)
        if mask is not None:
            logits = jnp.where(mask, logits,
                               jnp.finfo(logits.dtype).min)
        weights = softmax(logits, axis=-1)
        deterministic = (self.deterministic if deterministic is None
                         else deterministic)
        if self.dropout_rate > 0.0 and not deterministic:
            keep = 1.0 - self.dropout_rate
            m = jax.random.bernoulli(self.make_rng("dropout"), keep,
                                     weights.shape)
            weights = jnp.where(m, weights / keep, 0.0)
        out = jnp.einsum("...hqk,...khd->...qhd", weights, v)
        return DenseGeneral(features, axis=(-2, -1), use_bias=self.use_bias,
                            dtype=self.dtype, param_dtype=self.param_dtype,
                            kernel_init=self.kernel_init,
                            bias_init=self.bias_init, name="out")(out)

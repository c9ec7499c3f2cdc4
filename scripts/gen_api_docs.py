"""Generate docs/api/*.md from package docstrings.

The reference ships a full Sphinx API reference (docs/source); this
produces the equivalent markdown pages from our docstrings so the docs
stay in sync with the code. Run after adding public symbols:

    python scripts/gen_api_docs.py
"""

import importlib
import inspect
import os
import os.path as osp
import re
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, ROOT)

PACKAGES = [
    ("gammagl_tpu.ops", "Kernels: segment ops, SpMM, SDDMM, softmax"),
    ("gammagl_tpu.nn", "Module system (flax.linen interface)"),
    ("gammagl_tpu.data", "Graph / HeteroGraph / Batch / Dataset"),
    ("gammagl_tpu.datasets", "Dataset zoo"),
    ("gammagl_tpu.loader", "Loaders, samplers, prefetch, caches"),
    ("gammagl_tpu.sampler", "Sampler abstraction"),
    ("gammagl_tpu.layers.conv", "Convolution layers"),
    ("gammagl_tpu.layers.attention", "Attention layers"),
    ("gammagl_tpu.layers.pool", "Pooling"),
    ("gammagl_tpu.models", "Model zoo"),
    ("gammagl_tpu.transforms", "Transforms"),
    ("gammagl_tpu.utils", "Utilities"),
    ("gammagl_tpu.parallel", "Multi-device execution"),
    ("gammagl_tpu.train", "Train state, losses, checkpointing"),
    ("gammagl_tpu.serve", "Serving: AOT sessions, StableHLO export, "
     "micro-batching"),
    ("gammagl_tpu.csrc", "Native host sampler bindings"),
]


def first_para(doc):
    if not doc:
        return "(no docstring)"
    lines = []
    for ln in inspect.cleandoc(doc).splitlines():
        if not ln.strip() and lines:
            break
        if ln.strip():
            lines.append(ln.strip())
    # dataclass modules embed constructor reprs with run-specific addresses
    return re.sub(r" at 0x[0-9a-f]+", "", " ".join(lines))


def signature(obj):
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # default reprs like <object at 0x7f...> embed run-specific addresses;
    # strip them so regenerated docs are deterministic
    return re.sub(r" at 0x[0-9a-f]+", "", sig)


def render(modname, title):
    mod = importlib.import_module(modname)
    names = getattr(mod, "__all__", None) or sorted(
        n for n in vars(mod) if not n.startswith("_"))
    out = [f"# `{modname}`\n", f"{title}.\n"]
    if mod.__doc__:
        out.append(first_para(mod.__doc__) + "\n")
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        if inspect.isclass(obj):
            out.append(f"## class `{n}`\n")
            out.append(first_para(obj.__doc__) + "\n")
            # public methods defined on the class itself
            for mn, m in sorted(vars(obj).items()):
                if mn.startswith("_") or not callable(m):
                    continue
                out.append(f"- `{n}.{mn}{signature(m)}` — "
                           f"{first_para(m.__doc__)}")
            out.append("")
        elif callable(obj):
            out.append(f"## `{n}{signature(obj)}`\n")
            out.append(first_para(obj.__doc__) + "\n")
        else:
            out.append(f"## `{n}`\n\n{type(obj).__name__} constant.\n")
    return "\n".join(out)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    api_dir = osp.join(ROOT, "docs", "api")
    os.makedirs(api_dir, exist_ok=True)
    index = ["# API reference\n",
             "Generated by `scripts/gen_api_docs.py` from docstrings.\n"]
    for modname, title in PACKAGES:
        page = modname.replace("gammagl_tpu.", "").replace(".", "_") + ".md"
        with open(osp.join(api_dir, page), "w", encoding="utf-8") as f:
            f.write(render(modname, title))
        index.append(f"- [`{modname}`]({page}) — {title}")
        print("wrote", page)
    with open(osp.join(api_dir, "index.md"), "w", encoding="utf-8") as f:
        f.write("\n".join(index) + "\n")


if __name__ == "__main__":
    main()

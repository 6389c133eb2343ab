"""Helpers over parameter trees: nested dicts and lists of tensors, walked
in the JAX package's order (dict keys sorted, as its pytree flattening), so
leaf lists and checkpoint keys line up with the JAX package's."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """fn over the leaves of tree (and of the same-shaped trees in rest)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, prefix: str = "") -> dict:
    """{JAX key path (``['a'][0]['w']``): leaf}, in flattening order."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(tree_paths(tree[k], f"{prefix}['{k}']"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(tree_paths(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out

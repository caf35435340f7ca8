"""Trees of tensors in ``jax.tree_util``'s leaf order.

Params and optimizer state are nested dicts of tensors with the JAX
package's structure. A checkpoint stores their leaves as ``arr_<i>.npy``
in the order ``jax.tree_util.tree_flatten`` gives them: the keys of every
dict sorted, depth first. The global gradient norm sums its leaves in that
order too. This module is the one place that order is defined.
"""

from __future__ import annotations

from typing import Any, Callable, List

from ..models.sharding import P


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` (dicts and tuples nest; a partition spec
    ``P`` is a leaf, as in ``jax.tree_util``), dict keys sorted at every
    level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, P):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree of dict ``like``'s structure holding ``leaves`` in leaf
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` over the leaves of dict ``tree``."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def treedef_str(tree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints
    it for a tree of dicts: ``PyTreeDef({'a': *, 'b': {'c': *}})``."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"'{k}': {node(t[k])}"
                                   for k in sorted(t)) + "}"
        return "*"
    return f"PyTreeDef({node(tree)})"

"""Parameter trees of the LM code: nested dicts of tensors, the shape of
the reference's pytrees.

Leaves are visited in sorted-key order, as ``jax.tree.leaves`` visits a
dict, so sums over leaves (the AdamW global norm) add in the reference's
order.  A path is the keys from the root joined by ``.``; it is also the
``state_dict()`` key of the leaf in ``models.common.LMParams``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn

Tree = Any  # a tensor, or a dict of trees


def as_tree(params) -> Tree:
    """A tree, or an ``nn.Module`` -> the nested dict of its parameters
    (the tensors themselves, not copies)."""
    if not isinstance(params, nn.Module):
        return params
    return unflatten(params.named_parameters())


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """-> [(path, leaf)] in sorted-key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += flatten(tree[k], f"{prefix}.{k}" if prefix else k)
    return out


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(pairs) -> Dict[str, Any]:
    """[(path, leaf)] -> the nested dict."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        *heads, last = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def register(module: nn.Module, tree: Dict[str, Any]) -> None:
    """Register ``tree``'s leaves as parameters of ``module`` (sharing
    their storage), its sub-dicts as child modules, so that
    ``module.state_dict()`` keys are the tree's paths."""
    for k, v in tree.items():
        if isinstance(v, dict):
            child = nn.Module()
            register(child, v)
            module.add_module(k, child)
        else:
            module.register_parameter(
                k, nn.Parameter(v, requires_grad=torch.is_floating_point(v))
            )

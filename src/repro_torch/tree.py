"""Nested dicts and lists of tensors — the port's counterpart of the
reference's pytrees (parameters, gradients, optimizer state, checkpoints).

Dicts are walked in sorted-key order, so two trees with the same keys give
their leaves in the same order whatever order their dicts were built in.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over every leaf of ``tree``;
    returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_items(tree, prefix: str = "") -> list:
    """(path, leaf) pairs; a path joins the keys and list indices with "/"
    (the checkpoint's leaf names)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_paths(tree, prefix: str = ""):
    """A tree of the same structure whose leaves are their paths."""
    if isinstance(tree, dict):
        return {k: tree_paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_paths(v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return prefix[:-1]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]

"""Nested containers of leaves (the port's stand-in for jax pytrees).

A tree is nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, ndarrays or scalars; ``None`` is an empty subtree.  A leaf's key
is the ``/``-joined path jax's ``tree_flatten_with_path`` gives: dict
keys in sorted order, sequence indices as numbers, and a NamedTuple's
fields in their order as ``.name`` (``str`` of jax's ``GetAttrKey``), so
``{"opt_state": AdamState(step, m, v)}`` keys ``opt_state/.step``,
``opt_state/.m/...``.  The checkpoint manager and the serving engine
name their file variables by these keys.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def children(node) -> Iterator[Tuple[str, Any]]:
    """(key component, child) of a container, in jax's flattening order;
    nothing for a leaf or ``None``."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield str(k), node[k]
    elif is_namedtuple(node):
        for name in node._fields:
            yield f".{name}", getattr(node, name)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield str(i), v


def leaves_with_paths(tree, path: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf, in jax's flattening order."""
    if isinstance(tree, (dict, list, tuple)):
        for part, child in children(tree):
            yield from leaves_with_paths(child, path + (part,))
    elif tree is not None:
        yield path, tree


def leaves_with_keys(tree) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of every leaf, in jax's flattening order."""
    for path, leaf in leaves_with_paths(tree):
        yield "/".join(path), leaf


def map_with_keys(fn: Callable[[str, Any], Any], tree,
                  path: Tuple[str, ...] = ()):
    """`tree` with every leaf replaced by ``fn(key, leaf)``; containers
    keep their type (a dict its key order)."""
    if isinstance(tree, dict):
        return type(tree)((k, map_with_keys(fn, v, path + (str(k),)))
                          for k, v in tree.items())
    if is_namedtuple(tree):
        return type(tree)(*(map_with_keys(fn, v, path + (part,))
                            for part, v in children(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_keys(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else fn("/".join(path), tree)


def nest(flat: Dict[str, Any]) -> Dict:
    """Nested dicts from ``/``-joined keys (a NamedTuple's ``.name``
    fields come back as dict keys, as the reference's manager gives
    them)."""
    root: Dict = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root


__all__ = ["is_namedtuple", "children", "leaves_with_paths",
           "leaves_with_keys", "map_with_keys", "nest"]

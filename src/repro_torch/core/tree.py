"""Nested containers of leaves (the port's stand-in for jax pytrees).

A tree is nested dicts, lists and tuples whose leaves are tensors,
ndarrays or scalars; ``None`` is an empty subtree.  A leaf's key is the
``/``-joined path jax's ``tree_flatten_with_path`` gives: dict keys in
sorted order, sequence indices as numbers.  The checkpoint manager and
the serving engine name their file variables by these keys.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


def leaves_with_paths(tree, path: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf, in jax's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def leaves_with_keys(tree) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of every leaf, in jax's flattening order."""
    for path, leaf in leaves_with_paths(tree):
        yield "/".join(path), leaf


def map_with_keys(fn: Callable[[str, Any], Any], tree,
                  path: Tuple[str, ...] = ()):
    """`tree` with every leaf replaced by ``fn(key, leaf)``; containers
    keep their type."""
    if isinstance(tree, dict):
        return type(tree)((k, map_with_keys(fn, v, path + (str(k),)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_keys(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else fn("/".join(path), tree)


def nest(flat: Dict[str, Any]) -> Dict:
    """Nested dicts from ``/``-joined keys."""
    root: Dict = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root


__all__ = ["leaves_with_paths", "leaves_with_keys", "map_with_keys", "nest"]

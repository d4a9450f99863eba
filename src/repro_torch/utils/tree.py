"""Trees of tensors in the JAX package's pytree order.

The optimizers, the checkpoint manager and the train loop take their state
as a tree of dicts, lists, tuples and NamedTuples, as the JAX package does.
The order and the keys are JAX's: a dict's children in sorted key order, a
sequence's by index, a NamedTuple's by field, and ``None`` an empty subtree
(no leaf). ``torch.utils._pytree`` keeps a dict's insertion order and yields
``None`` as a leaf, so its keys and leaf order part from JAX's; these
helpers do not.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node) -> list[tuple[Any, Any]] | None:
    """(key, child) pairs of a container in JAX's order; None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _rebuild(node, values: dict):
    """``node``'s container with each child replaced by ``values[key]``."""
    if isinstance(node, dict):
        return {k: values[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(values[f] for f in node._fields))
    return type(node)(values[i] for i in range(len(node)))


def _child(node, key):
    return getattr(node, key) if _is_namedtuple(node) else node[key]


def tree_map(fn: Callable, tree, *rest, with_path: bool = False, _path: tuple = ()):
    """``tree`` with every leaf ``x`` replaced by ``fn(x, *r)``, where each
    ``r`` is the subtree of the matching ``rest`` tree at that leaf's place
    (JAX's ``flatten_up_to``: a leaf of ``tree`` may face a whole subtree of
    another). ``with_path`` passes the leaf's key path (a tuple) first."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(_path, tree, *rest) if with_path else fn(tree, *rest)
    return _rebuild(tree, {
        k: tree_map(fn, v, *(_child(r, k) for r in rest), with_path=with_path,
                    _path=_path + (k,))
        for k, v in kids})


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order (``None`` yields none)."""
    out: list = []
    tree_map(out.append, tree)
    return out


def path_key(path: tuple) -> str:
    """The key the JAX package's checkpoint manager names a leaf by: the
    path's dict keys, indices and field names joined by ``/``."""
    return "/".join(str(p) for p in path)


def leaves_with_paths(tree) -> list[tuple[str, Any]]:
    """(``path_key``, leaf) in JAX's order."""
    out: list = []
    tree_map(lambda path, leaf: out.append((path_key(path), leaf)), tree, with_path=True)
    return out


__all__ = ["tree_map", "tree_leaves", "leaves_with_paths", "path_key"]

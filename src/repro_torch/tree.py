"""Trees of dicts, lists and tuples (named tuples too), as the port's
checkpoints and partition specs walk them: a dict key names its subtree,
a sequence index is its position."""
from __future__ import annotations


def map_with_path(fn, tree, is_leaf=None, path=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``, where
    ``path`` holds the dict keys and sequence indices above the leaf. A
    leaf is anything but a dict, a list or a tuple, or what ``is_leaf``
    accepts."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, is_leaf, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_with_path(fn, v, is_leaf, path + (i,))
                 for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(path, tree)


def leaves_with_path(tree, is_leaf=None) -> list:
    """``[(path, leaf), ...]`` in the tree's order."""
    out = []
    map_with_path(lambda path, leaf: out.append((path, leaf)), tree, is_leaf)
    return out

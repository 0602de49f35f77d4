"""Nested dicts and lists of tensors (the port's parameter and state trees):
walk them in a fixed order, map over them, and name their leaves."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def tree_items(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs: dict keys in sorted order, list items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn: Callable, tree, *rest, path: Path = (), with_path=False):
    """fn(leaf, *leaves of ``rest`` at the same place) over ``tree``'s
    structure, visiting leaves in ``tree_items`` order; ``with_path``
    passes the leaf's path first."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            path=path + (k,), with_path=with_path)
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest), path=path + (i,),
                         with_path=with_path) for i, v in enumerate(tree)]
    return fn(path, tree, *rest) if with_path else fn(tree, *rest)

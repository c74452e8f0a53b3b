"""Minimal pytrees over dicts, lists, tuples and NamedTuples.

Leaf order is ``jax.tree.flatten``'s: dict keys sorted (recursively),
NamedTuple fields in declaration order, list/tuple items in order; ``None``
is an empty subtree. The fused exchange lays leaves out in this order, so it
must agree with the JAX reference offset for offset. (Python dicts keep
insertion order, hence the explicit sort.)
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


class TreeDef:
    """Structure of a pytree: ``kind`` plus child structures."""

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta: Any = None, children: Tuple = ()):
        self.kind = kind          # "leaf" | "none" | "dict" | "list" | "tuple" | "namedtuple"
        self.meta = meta          # sorted keys / NamedTuple class
        self.children = children

    def _key(self):
        return (self.kind, self.meta, tuple(c._key() for c in self.children))

    def __eq__(self, other) -> bool:
        return isinstance(other, TreeDef) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"TreeDef({self.kind}, {self.meta}, {list(self.children)})"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_into(t: Any, leaves: List[Any], is_leaf=None) -> TreeDef:
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return TreeDef("leaf")
    if t is None:
        return TreeDef("none")
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return TreeDef("dict", keys, tuple(_flatten_into(t[k], leaves, is_leaf) for k in keys))
    if _is_namedtuple(t):
        return TreeDef("namedtuple", type(t),
                       tuple(_flatten_into(c, leaves, is_leaf) for c in t))
    if isinstance(t, (list, tuple)):
        kind = "list" if isinstance(t, list) else "tuple"
        return TreeDef(kind, len(t), tuple(_flatten_into(c, leaves, is_leaf) for c in t))
    leaves.append(t)
    return TreeDef("leaf")


def _build(td: TreeDef, it) -> Any:
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
    if td.kind == "dict":
        return dict(zip(td.meta, kids))
    if td.kind == "namedtuple":
        return td.meta(*kids)
    return kids if td.kind == "list" else tuple(kids)


# Module-level recursion on purpose: a recursive closure is a reference
# cycle that would keep every leaf it saw (multi-GB tensors) alive until the
# cyclic garbage collector happens to run.
def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], TreeDef]:
    """Leaves and structure; ``is_leaf(node)`` true stops the descent there
    (``jax.tree.flatten``'s ``is_leaf``)."""
    leaves: List[Any] = []
    treedef = _flatten_into(tree, leaves, is_leaf)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])

"""Walking two trees of one structure together.

The port's trees are nested dicts, lists (per-layer parameters) and
NamedTuples (``train.optim.AdamWState``) of tensors.  A dict's key order
depends on how it was built (the port's ``init_params`` and a tree
converted from JAX, whose dicts are sorted, order the same keys
differently), so a second tree is read in the order of the first's
keys, never in its own.
"""
from __future__ import annotations

from typing import Any, List


def leaves_as(ref: Any, tree: Any) -> List[Any]:
    """The leaves of ``tree`` in the order in which
    ``torch.utils._pytree.tree_leaves(ref)`` gives those of ``ref``;
    ``tree`` has ``ref``'s structure (its dicts may order their keys
    differently)."""
    if isinstance(ref, dict):
        if ref.keys() != tree.keys():
            raise ValueError(f"keys differ: {sorted(ref)} vs {sorted(tree)}")
        return [x for k in ref for x in leaves_as(ref[k], tree[k])]
    if isinstance(ref, (list, tuple)):
        if len(ref) != len(tree):
            raise ValueError(f"lengths differ: {len(ref)} vs {len(tree)}")
        return [x for r, t in zip(ref, tree) for x in leaves_as(r, t)]
    return [tree]

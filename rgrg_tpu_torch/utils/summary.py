"""Model introspection: parameter counts per module subtree (the port's
counterpart of the JAX package's `utils/summary.py`, which replaces the
reference's torchinfo summary helper, language_model.py:655-677).

A tree is the port's parameter tree: nested mappings of tensors or numpy
arrays, where an `nn.Module` (the detector) contributes
its `named_parameters`, each dotted name split into path components.
Buffers (BatchNorm's running statistics) are not parameters and are not
counted.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Mapping, Tuple

import torch


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in the order of the JAX package's tree flattening
    (mapping keys sorted)."""
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield path + tuple(name.split(".")), p
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield path, tree


def param_counts(tree: Any, depth: int = 2) -> Dict[str, int]:
    """Parameter counts grouped by the first `depth` path components."""
    counts: Dict[str, int] = {}
    for path, leaf in _leaves(tree):
        key = "/".join(path[:depth])
        counts[key] = counts.get(key, 0) + math.prod(leaf.shape)
    return counts


def summarize(tree: Any, depth: int = 2) -> str:
    counts = param_counts(tree, depth)
    total = sum(counts.values())
    lines = [f"{'module':50s} {'params':>14s}"]
    for k in sorted(counts):
        lines.append(f"{k:50s} {counts[k]:>14,d}")
    lines.append(f"{'TOTAL':50s} {total:>14,d}")
    return "\n".join(lines)

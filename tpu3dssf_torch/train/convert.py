"""Layout conversion of JAX state trees: unrolled blocks ↔ scan stacks.

Port of ``tpu3dssf.train.convert``, in numpy alone. The JAX package's
``PTv3Config.scan_blocks`` (and ``ViTConfig.scan_layers``) change the
layout of its parameter tree: per-block subtrees ``enc3_blk0..blk5``
become one ``enc3_scan`` subtree whose leaves carry a leading depth axis
(ViT: ``block0..blockN`` → ``blocks``). :func:`convert_tree` restacks or
unstacks any such state tree, the parameters and the optimizer moments
that mirror them, in either direction:

    restacked = convert_tree(tree, to_scan=True)    # blk{i} → _scan
    unrolled  = convert_tree(tree, to_scan=False)   # _scan → blk{i}

The tree is nested mappings (a flax tree after ``jax.device_get``, or an
Orbax restore), lists and tuples (an optax chain's states, namedtuples
rebuilt by their own type) with array leaves; ``jax.tree.map`` becomes
plain recursion over them, and a round trip gives the same bits.
:func:`tpu3dssf_torch.convert.pipeline_state_dict_from_flax` unstacks a
scan tree with it, so weights that a TPU run saved under ``scan_blocks``
load into the port without the JAX package.

Not ported: ``scripts/convert_checkpoint.py``, which reads and writes
Orbax checkpoints and so needs JAX. The port's own checkpoints
(``torch.save`` of a state dict, :mod:`tpu3dssf_torch.train.checkpoint`)
have no scan layout: the port runs every block unrolled.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any

import numpy as np

_BLK = re.compile(r"^(.+)_blk(\d+)$")     # PTv3 unrolled stage blocks
_SCAN = re.compile(r"^(.+)_scan$")        # PTv3 scanned stage
_VIT_BLK = re.compile(r"^block(\d+)$")    # ViT unrolled layers
_VIT_SCAN = "blocks"                      # ViT scanned layers


def _map(fn, *trees):
    """``fn`` over the leaves of identically structured trees (mappings,
    lists, tuples), keeping the first tree's containers."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        out = [_map(fn, *xs) for xs in zip(*trees)]
        return _rebuild(first, out)
    return fn(*trees)


def _rebuild(like, items):
    """``items`` in the container type of ``like`` (a list, a tuple or a
    namedtuple, which takes its fields as arguments)."""
    if isinstance(like, tuple):
        return (type(like)(*items) if hasattr(like, "_fields")
                else tuple(items))
    return list(items)


def _leaves(tree):
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stack_subtrees(subtrees):
    """Stack identically structured trees along a new leading axis."""
    return _map(lambda *xs: np.stack([np.asarray(x) for x in xs], axis=0),
                *subtrees)


def _unstack_subtree(tree, depth: int):
    return [_map(lambda a, i=i: np.asarray(a)[i], tree)
            for i in range(depth)]


def _leading_dim(tree) -> int:
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("cannot unstack an empty subtree")
    return int(np.asarray(leaves[0]).shape[0])


def _contiguous(name, idxs):
    if idxs != list(range(len(idxs))):
        raise ValueError(f"non-contiguous block indices for {name}: {idxs}")


def convert_tree(tree: Any, to_scan: bool) -> Any:
    """Convert the block layout anywhere in a state tree (see the module
    docstring). Leaves that are not containers pass through untouched.
    Depth-1 PTv3 stages keep their ``_blk0`` name in both layouts (the JAX
    model scans only stages deeper than one block)."""
    if isinstance(tree, (list, tuple)):
        return _rebuild(tree, [convert_tree(v, to_scan) for v in tree])
    if not isinstance(tree, Mapping):
        return tree

    out = {}
    if to_scan:
        groups, vit_groups = {}, {}
        for k, v in tree.items():
            m, mv = _BLK.match(k), _VIT_BLK.match(k)
            if m and isinstance(v, Mapping):
                groups.setdefault(m.group(1), {})[int(m.group(2))] = v
            elif mv and isinstance(v, Mapping):
                vit_groups[int(mv.group(1))] = v
            else:
                out[k] = convert_tree(v, to_scan)
        for name, blocks in sorted(groups.items()):
            idxs = sorted(blocks)
            _contiguous(name, idxs)
            if len(idxs) == 1:
                out[f"{name}_blk0"] = convert_tree(blocks[0], to_scan)
            else:
                out[f"{name}_scan"] = _stack_subtrees(
                    [convert_tree(blocks[i], to_scan) for i in idxs])
        if vit_groups:
            idxs = sorted(vit_groups)
            _contiguous("the ViT", idxs)
            out[_VIT_SCAN] = _stack_subtrees(
                [convert_tree(vit_groups[i], to_scan) for i in idxs])
        return out

    for k, v in tree.items():
        m = _SCAN.match(k)
        if m and isinstance(v, Mapping):
            for i, sub in enumerate(_unstack_subtree(v, _leading_dim(v))):
                out[f"{m.group(1)}_blk{i}"] = sub
        elif k == _VIT_SCAN and isinstance(v, Mapping):
            for i, sub in enumerate(_unstack_subtree(v, _leading_dim(v))):
                out[f"block{i}"] = sub
        else:
            out[k] = convert_tree(v, to_scan)
    return out

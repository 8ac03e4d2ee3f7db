"""Assertion helpers (counterpart of `hanabi_sad_tpu/utils/asserts.py`).

Scalar asserts, and tensor and tree asserts on torch tensors (numpy arrays
and numbers are taken too). A mismatch raises AssertionError with its
largest absolute difference. Trees are the port's containers: NamedTuples,
dicts (walked in sorted key order, as JAX's tree_util walks them), lists and
tuples, with tensors, arrays or numbers at the leaves; None is an empty
subtree. `tree_flatten` is this module's own walk over them.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch


def assert_eq(real, expected):
    assert real == expected, f"{real} (true) vs {expected} (expected)"


def assert_neq(real, expected):
    assert real != expected, f"{real} (true) vs {expected} (expected)"


def assert_lt(real, expected):
    assert real < expected, f"{real} (true) vs {expected} (expected)"


def assert_lteq(real, expected):
    assert real <= expected, f"{real} (true) vs {expected} (expected)"


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float64)


def assert_tensor_eq(t1, t2, eps: float = 1e-6):
    """Same shape, and every element within eps (strictly)."""
    a, b = _f64(t1), _f64(t2)
    assert a.shape == b.shape, f"size mismatch {tuple(a.shape)} vs {tuple(b.shape)}"
    diff = (a - b).abs()
    assert bool((diff < eps).all()), f"max diff {float(diff.max())} >= {eps}"


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves in walk order, a description of the structure that compares
    equal for trees of the same structure)."""
    leaves: List[Any] = []

    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(walk(x[k]) for k in keys))
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return (type(x).__name__, tuple(x._fields), tuple(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return (type(x).__name__, tuple(walk(v) for v in x))
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def assert_tree_close(tree1, tree2, eps: float = 1e-6):
    """assert_tensor_eq over every leaf of two trees of the same structure."""
    leaves1, tdef1 = tree_flatten(tree1)
    leaves2, tdef2 = tree_flatten(tree2)
    assert tdef1 == tdef2, f"tree structure mismatch: {tdef1} vs {tdef2}"
    for l1, l2 in zip(leaves1, leaves2):
        assert_tensor_eq(l1, l2, eps)


def assert_zero_grad(grads):
    """Every leaf of a tree of gradients is exactly zero (a None grad, which
    autograd gives a tensor it did not reach, counts as zero)."""
    for leaf in tree_flatten(grads)[0]:
        s = float(_f64(leaf).abs().sum())
        assert s == 0.0, f"nonzero grad (abs-sum {s})"

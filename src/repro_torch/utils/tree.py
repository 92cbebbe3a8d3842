"""Parameter trees: nested dicts of tensors with the JAX package's key names.

Leaf order is JAX's: ``jax.tree.leaves`` visits dict keys in sorted order,
while Python dicts keep insertion order (the solar schema inserts
``encoder, decoder, head_w, head_b`` and ``wx, wh, b``).  Every flat
vector in the port is laid out in the sorted order, so it lines up with the
reference's ``flatten_params`` element for element.

The weights bridge (``params_from_numpy`` / ``params_to_numpy``) carries
parameter trees between the packages as numpy arrays.  The arithmetic
helpers (``tree_add`` ... ``global_norm``) are the reference's, leaf by
leaf in the same order.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """Leaves in JAX's order (dict keys sorted, depth first)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over matching leaves; the result keeps ``tree``'s key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def param_count(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_weighted_sum(trees, weights):
    """sum_i weights[i] * trees[i], folded left to right as the reference
    does (the FedAvg primitive; the store's folds use the kernel)."""
    if not trees or len(trees) != len(weights):
        raise ValueError("tree_weighted_sum needs one weight a tree")
    out = tree_scale(trees[0], weights[0])
    for t, w in zip(trees[1:], weights[1:], strict=True):
        out = tree_map(lambda a, b, w=w: a + b * w, out, t)
    return out


def tree_dot(a, b):
    """sum over the leaves of sum(x * y) in f32, added in leaf order."""
    f32 = torch.float32
    return sum(torch.sum(x.to(f32) * y.to(f32))
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def global_norm(tree):
    """sqrt of the f32 sums of squares of the leaves, added in leaf order."""
    f32 = torch.float32
    return torch.sqrt(torch.as_tensor(
        sum(torch.sum(torch.square(x.to(f32))) for x in tree_leaves(tree)),
        dtype=f32))


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    return all(np.allclose(_to_numpy(x).astype(np.float64),
                           _to_numpy(y).astype(np.float64),
                           rtol=rtol, atol=atol)
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def flatten_params(tree) -> torch.Tensor:
    """Concatenate every leaf into one flat f32 vector (kernel-facing layout)."""
    return torch.cat([x.reshape(-1).to(torch.float32) for x in tree_leaves(tree)])


def unflatten_params(flat: torch.Tensor, template):
    """Inverse of ``flatten_params``: leaves are views of ``flat`` cast to the
    template's dtypes, in the template's key order."""
    sizes = [x.numel() for x in tree_leaves(template)]
    if sum(sizes) != flat.numel():
        raise ValueError(f"flat vector has {flat.numel()} elements, the "
                         f"template needs {sum(sizes)}")
    views = iter(flat.split(sizes))        # one call for every leaf's slice

    def go(node):
        if isinstance(node, dict):
            built = {k: go(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        leaf = next(views).view(node.shape)
        return leaf if leaf.dtype == node.dtype else leaf.to(node.dtype)

    return go(template)


def _from_numpy(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 (what JAX hands numpy) has no torch
        # counterpart in torch.from_numpy: carry its bits as int16
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes   # only for bf16 trees; ships with JAX and numpy users

        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def params_from_numpy(tree, device) -> dict:
    """A tree of numpy arrays (e.g. JAX params through ``np.asarray``) as
    tensors on ``device``; always copies.  bfloat16 arrays keep their bits."""
    return tree_map(lambda x: _from_numpy(x, device), tree)


def params_to_numpy(tree) -> dict:
    """Inverse of ``params_from_numpy``; bfloat16 tensors become
    ``ml_dtypes.bfloat16`` arrays, bit for bit."""
    return tree_map(_to_numpy, tree)

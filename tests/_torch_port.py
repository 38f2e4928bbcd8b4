"""Helpers shared by the PyTorch-port parity tests: the framework-to-numpy
half of carrying arrays across (the port itself never sees the reference)."""

import numpy as np
import torch


def np_tree(tree):
    """A reference pytree (nested dicts of jax arrays) as nested dicts of
    numpy arrays; bf16 leaves widen to fp32, which is exact."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind not in "iub" and arr.dtype != np.float32:
        arr = np.asarray(tree, dtype=np.float32)
    return arr


def t(arr, dtype=None):
    """numpy -> CPU tensor."""
    out = torch.tensor(np.asarray(arr))
    return out if dtype is None else out.to(dtype)


def to_np(x):
    """tensor -> fp32/int numpy."""
    x = x.detach().cpu()
    return (x.to(torch.float32) if x.is_floating_point() else x).numpy()


def assert_tree_close(ours, theirs, *, atol, rtol, path=""):
    """Compare a port cache (tensors) with a reference cache (numpy)."""
    if theirs is None:
        assert ours is None, path
        return
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs), (path, set(ours), set(theirs))
        for k in theirs:
            assert_tree_close(ours[k], theirs[k], atol=atol, rtol=rtol,
                              path=f"{path}/{k}")
        return
    got = to_np(ours)
    assert got.shape == theirs.shape, (path, got.shape, theirs.shape)
    if theirs.dtype.kind in "iub":
        np.testing.assert_array_equal(got, theirs, err_msg=path)
    else:
        np.testing.assert_allclose(got, theirs, atol=atol, rtol=rtol, err_msg=path)


def perturbed(tree, seed):
    """A reference param tree (as numpy) with every leaf moved by a seeded
    draw, so that zero biases and unit norm weights take part in a
    comparison."""
    rng = np.random.default_rng(seed)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        x = np.asarray(x, np.float32)
        return (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return leaf(np_tree(tree))

"""The comparison the tracking-evaluation parity tests share: two result
trees (nested dicts, lists and tuples of numbers and arrays) are equal
key for key, and every number agrees to a relative tolerance (1e-12
unless stated: the port's evaluation modules are the JAX package's numpy
code, so the two are expected to agree bit for bit)."""
import numpy as np

RTOL = 1e-12


def assert_tree_equal(a, b, path: str = "", rtol: float = RTOL) -> None:
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}", rtol)
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]", rtol)
    elif a is None or isinstance(a, (str, bytes)):
        assert a == b, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        np.testing.assert_allclose(x, y, rtol=rtol, atol=0, err_msg=path)

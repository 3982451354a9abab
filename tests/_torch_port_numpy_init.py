"""A flax module's variables drawn with numpy, for the port's CPU tests.

``jax.eval_shape`` of the module's init gives the tree; each parameter is
drawn from its flax initializer's distribution (lecun_normal for a
convolution's kernel, the truncated normal 0.02 of the JAX package's Dense
layers and tokens for every other kernel, zero biases, unit scales) and
perturbed so zero-initialised leaves matter; batch statistics are positive.
Calling ``init`` itself runs the module's forward, and for a large model
compiles it: several seconds a model that a test file pays for nothing, since
both sides load the same numbers anyway.
"""

import functools

import numpy as np

import jax


def truncated_normal(rs: np.random.RandomState, shape, std: float) -> np.ndarray:
    """N(0, std) truncated at two of its standard deviations."""
    z = rs.randn(*shape)
    while (bad := np.abs(z) > 2).any():
        z[bad] = rs.randn(int(bad.sum()))
    return (z * std).astype(np.float32)


def numpy_variables(jmod, *args, seed: int = 0, scale: float = 0.02, **kwargs):
    """(params, batch_stats) of the flax module ``jmod`` called on ``args``."""
    shapes = jax.eval_shape(functools.partial(jmod.init, **kwargs), jax.random.key(0), *args)
    rs = np.random.RandomState(seed)

    def draw(path, sd):
        names = [p.key for p in path]
        if names[-1].endswith("bias"):
            v = np.zeros(sd.shape, np.float32)
        elif names[-1] == "scale":
            v = np.ones(sd.shape, np.float32)
        elif any("conv" in n for n in names) and len(sd.shape) > 2:  # lecun_normal
            v = truncated_normal(rs, sd.shape, (1.0 / np.prod(sd.shape[:-1])) ** 0.5
                                 / 0.87962566103423978)
        else:
            v = truncated_normal(rs, sd.shape, 0.02)
        return v + scale * rs.randn(*sd.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, shapes["params"])
    stats = jax.tree_util.tree_map(lambda sd: (0.5 + rs.rand(*sd.shape)).astype(np.float32),
                                   shapes.get("batch_stats", {}))
    return params, stats

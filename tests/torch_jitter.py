"""JAX's ColorJitter draws in the port's layout, for the port's jitter
tests: the factors and op orders that the JAX package's
``ops/photometric.color_jitter`` draws from a key, computed from the same
key splits (its ``_jitter_one``: split(key, B), then per sample
kp, kb, kc, ks = split(key, 4), three uniforms and permutation(kp, 3))."""

import jax
import jax.numpy as jnp
import numpy as np


def jax_jitter_draws(key, batch: int, amounts):
    """(factors (B, 3) float32, orders (B, 3) int64) as numpy arrays."""
    factors, orders = [], []
    for k in jax.random.split(key, batch):
        kp, kb, kc, ks = jax.random.split(k, 4)
        factors.append([float(jax.random.uniform(
            sub, (), jnp.float32, max(0.0, 1.0 - a), 1.0 + a))
            for sub, a in zip((kb, kc, ks), amounts)])
        orders.append(np.asarray(jax.random.permutation(kp, 3)))
    return (np.asarray(factors, np.float32),
            np.asarray(orders, np.int64))

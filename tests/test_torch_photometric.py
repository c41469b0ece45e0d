"""PyTorch port, photometric jitter (ops/photometric.py) against the JAX
package's ``color_jitter`` and ``color_jitter_normalized`` on the CPU: the
port applies JAX's own draws (tests/torch_jitter.py) to the same images.

Tolerance: atol 1e-6 in float32.  The blends are the same float32
operations; only the gray sum over three channels and the contrast mean
over the image may add in another order (a few ulps of values in [0, 1]).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.ops import photometric as jphoto
from infantposeestimation_gaussianbias_tpu_torch.ops import photometric

from tests.torch_jitter import jax_jitter_draws
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
ATOL = 1e-6


def _images(seed, B=6, H=12, W=10):
    return np.random.RandomState(seed).rand(B, H, W, 3).astype(np.float32)


@pytest.mark.parametrize("amounts", [(0.2, 0.2, 0.2), (0.5, 0.0, 0.3),
                                     (0.0, 0.9, 0.0), (1.5, 0.4, 1.2)])
def test_color_jitter_matches_jax_with_its_draws(amounts):
    imgs = _images(0)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jphoto.color_jitter(key, jnp.asarray(imgs), *amounts))
    factors, orders = jax_jitter_draws(key, imgs.shape[0], amounts)
    assert sorted(map(tuple, orders)) != [(0, 1, 2)] * len(orders)
    got = photometric.color_jitter(
        torch.from_numpy(imgs), amounts,
        jitter=(torch.from_numpy(factors), torch.from_numpy(orders)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert got.min() >= 0 and got.max() <= 1
    assert not np.allclose(got.numpy(), imgs)


def test_color_jitter_normalized_matches_jax_with_its_draws():
    amounts = (0.2, 0.2, 0.2)  # the preemie config's
    x01 = _images(1, B=4, H=16, W=12)
    imgs = (x01 - np.float32(MEAN)) / np.float32(STD)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jphoto.color_jitter_normalized(
        key, jnp.asarray(imgs), MEAN, STD, *amounts))
    factors, orders = jax_jitter_draws(key, imgs.shape[0], amounts)
    got = photometric.color_jitter_normalized(
        torch.from_numpy(imgs), MEAN, STD, amounts,
        jitter=(torch.from_numpy(factors), torch.from_numpy(orders)))
    # normalised values reach ~2.6: the same ulps scaled by 1 / std
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL / min(STD),
                               rtol=0)


def test_zero_amounts_are_no_op():
    imgs = torch.from_numpy(_images(2))
    assert photometric.color_jitter(imgs, (0.0, 0.0, 0.0)) is imgs
    assert photometric.color_jitter_normalized(imgs, MEAN, STD,
                                               (0, 0, 0)) is imgs


def test_draws_come_from_the_generator():
    """Factors within [max(0, 1 - a), 1 + a] (exactly 1 at a = 0), every
    row of the orders a permutation, the same draws from the same seed."""
    amounts = (0.2, 0.0, 1.5)
    a = photometric.draw_jitter(512, amounts,
                                torch.Generator().manual_seed(5))
    b = photometric.draw_jitter(512, amounts,
                                torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    f, order = a
    assert f.shape == (512, 3) and f.dtype == torch.float32
    assert order.shape == (512, 3) and order.dtype == torch.int64
    assert (f[:, 0] >= 0.8).all() and (f[:, 0] <= 1.2).all()
    assert (f[:, 1] == 1.0).all()
    assert (f[:, 2] >= 0.0).all() and (f[:, 2] <= 2.5).all()
    assert (order.sort(dim=1).values == torch.arange(3)).all()
    assert len({tuple(r) for r in order.tolist()}) == 6

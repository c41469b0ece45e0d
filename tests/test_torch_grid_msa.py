"""PyTorch port, process grid: K3 (``window_attention_sharded``) on a 2 x 2
grid of gloo ranks on the CPU against the JAX package's
``window_attention_pallas_qkv_sharded`` on a 2 x 2 mesh of virtual CPU
devices (its Pallas kernels in interpret mode), and the mesh helpers
(``create_mesh``'s errors, ``process_shard``, the host gathers).

One ``run_grid`` spawn (4 ranks, module fixture) runs every rank-side
case (tests/torch_grid.py ``mesh_rank``); the tests read its results.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from infantposeestimation_gaussianbias_tpu.ops.pallas import window_msa as jwm
from infantposeestimation_gaussianbias_tpu.parallel import mesh as jmesh
from infantposeestimation_gaussianbias_tpu_torch import parallel

from tests import torch_grid
from tests.torch_tiny import one_torch_thread  # noqa: F401 (autouse)

N = 49
# (nW, H, hd): head-parallel on model = 2 with nW padded 29 -> 30 for
# data = 2; and H = 3, which the model axis does not divide (replicated).
CASES = [(29, 4, 16), (13, 3, 16)]
# float32 against float32: the same maths in other summation orders
# (JAX's interpreted kernel and XLA against torch's CPU einsum); outputs
# and dqkv are O(1), dbias sums up to 30 windows of dS.
ATOL, DBIAS_ATOL = 1e-5, 1e-4


def _inputs(nW, H, hd, seed):
    rng = np.random.RandomState(seed)
    C = H * hd
    return (rng.randn(nW, N, 3 * C).astype(np.float32),
            rng.randn(H, N, N).astype(np.float32))


@pytest.fixture(scope="module")
def jax_results():
    """JAX's forward, dqkv and dbias under sum(sin(out)) for each case."""
    mesh = jmesh.create_mesh(2, 2, devices=jax.devices()[:4])
    out = []
    for i, (nW, H, hd) in enumerate(CASES):
        qkv, bias = _inputs(nW, H, hd, seed=i)

        def loss(q, b):
            y = jwm.window_attention_pallas_qkv_sharded(q, b, H, mesh)
            return jnp.sum(jnp.sin(y)), y

        with jwm.interpret_mode():
            (_, y), (dq, db) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(jnp.asarray(qkv),
                                                     jnp.asarray(bias))
        out.append(tuple(np.asarray(a) for a in (y, dq, db)))
    return out


@pytest.fixture(scope="module")
def grid_results(request):
    """Every rank's results of tests/torch_grid.py ``mesh_rank``; the ranks
    run while this process computes JAX's results."""
    cases = []
    for i, (nW, H, hd) in enumerate(CASES):
        qkv, bias = _inputs(nW, H, hd, seed=i)
        pad = -nW % 2  # JAX pads the windows to a multiple of 'data'
        cases.append(dict(qkv=np.pad(qkv, ((0, pad), (0, 0), (0, 0))),
                          bias=bias, H=H, nW=nW))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(parallel.run_grid, torch_grid.mesh_rank, 2, 2,
                            "gloo", device="cpu", args=(cases,), timeout=300)
        request.getfixturevalue("jax_results")
        return ranks.result()


def test_ranks_sit_on_the_grid_and_import_no_jax(grid_results):
    assert [r["rank"] for r in grid_results] == [0, 1, 2, 3]
    assert [r["coords"] for r in grid_results] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    assert all(r["jax_modules"] == [] for r in grid_results)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_sharded_window_attention_matches_jax(case, grid_results,
                                              jax_results):
    """Forward, dqkv and dbias of K3's plain version on 2 x 2 gloo ranks
    against JAX's sharded kernel; both model ranks of a data rank hold the
    same rows, and every rank holds JAX's whole dbias."""
    nW = CASES[case][0]
    y, dq, db = jax_results[case]
    res = [r["cases"][case] for r in grid_results]
    for key in ("out", "dqkv"):
        for d in range(2):
            np.testing.assert_array_equal(res[2 * d][key],
                                          res[2 * d + 1][key])
        got = np.concatenate([res[0][key], res[2][key]])
        want = y if key == "out" else dq
        np.testing.assert_allclose(got[:nW], want, atol=ATOL, rtol=ATOL,
                                   err_msg=key)
    for r in res:
        np.testing.assert_allclose(r["dbias"], db, atol=DBIAS_ATOL,
                                   rtol=ATOL)


def test_create_mesh_errors(grid_results):
    """The JAX package's message for a grid that does not cover the ranks,
    for an explicit data axis and for data_axis <= 0."""
    for r in grid_results:
        assert r["mesh_errors"] == ["mesh 3x2 does not cover 4 devices",
                                    "mesh 1x3 does not cover 4 devices"]


def test_create_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        parallel.create_mesh(1, 1, device="cpu")


def test_host_gathers(grid_results):
    """gather_data_rows puts the data ranks' rows back in order on every
    rank; allgather_host_values concatenates over all four ranks."""
    rows = np.arange(8 * 3).reshape(8, 3)
    for r in grid_results:
        np.testing.assert_array_equal(r["gathered"], rows)
        np.testing.assert_array_equal(r["all_ranks"], [0, 1, 2, 3])


@pytest.mark.parametrize("n,pc,equalize", [
    (10, 1, "truncate"), (10, 3, "truncate"), (10, 3, "pad"),
    (7, 4, "pad"), (8, 4, "truncate"), (5, 2, "pad")])
def test_process_shard_matches_jax(n, pc, equalize):
    records = [{"id": i} for i in range(n)]
    for pi in range(pc):
        assert parallel.process_shard(records, pi, pc, equalize) == \
            jmesh.process_shard(records, pi, pc, equalize)


def test_process_shard_unknown_mode():
    with pytest.raises(ValueError, match="Unknown equalize mode"):
        parallel.process_shard([{"id": 0}, {"id": 1}], 0, 2, "drop")


def test_shard_batch_takes_this_data_ranks_rows():
    grid = parallel.ProcessGrid(data=2, model=2, rank=3, data_index=1,
                                model_index=1, data_group=None,
                                model_group=None, world_group=None,
                                device=torch.device("cpu"))
    batch = {"x": np.arange(8), "y": torch.arange(16).reshape(8, 2)}
    got = parallel.shard_batch(batch, grid)
    np.testing.assert_array_equal(got["x"], [4, 5, 6, 7])
    assert got["y"].tolist() == [[8, 9], [10, 11], [12, 13], [14, 15]]
    with pytest.raises(ValueError, match="do not split"):
        parallel.shard_batch(np.arange(5), grid)


@pytest.mark.parametrize("heads", [(0, 2), (2, 2), (1, 3)])
def test_head_range_is_those_heads_of_the_whole_call(heads):
    """K1's and K2's head range (their plain versions here): the heads'
    columns of the whole call, zeros elsewhere; dbias likewise by tiles."""
    from infantposeestimation_gaussianbias_tpu_torch.kernels import (
        window_msa as wm)

    rng = np.random.RandomState(9)
    H, hd, nW = 4, 8, 5
    C = H * hd
    qkv = torch.from_numpy(rng.randn(nW, N, 3 * C).astype(np.float32))
    bias = torch.from_numpy(rng.randn(H, N, N).astype(np.float32))
    dout = torch.from_numpy(rng.randn(nW, N, C).astype(np.float32))
    h0, hl = heads
    cols = [slice(t * C + h0 * hd, t * C + (h0 + hl) * hd) for t in range(3)]
    out = wm.window_attention_qkv(qkv, bias, H, heads)
    whole = wm.window_attention_qkv(qkv, bias, H)
    torch.testing.assert_close(out[..., cols[0]], whole[..., cols[0]],
                               atol=1e-6, rtol=1e-6)
    out[..., cols[0]] = 0
    assert not out.any()
    dq, db = wm.window_attention_qkv_bwd(qkv, bias, dout, H, heads)
    dq_all, db_all = wm.window_attention_qkv_bwd(qkv, bias, dout, H)
    for c in cols:
        torch.testing.assert_close(dq[..., c], dq_all[..., c], atol=1e-5,
                                   rtol=1e-5)
        dq[..., c] = 0
    assert not dq.any()
    torch.testing.assert_close(db[h0:h0 + hl], db_all[h0:h0 + hl],
                               atol=1e-5, rtol=1e-5)
    assert not db[:h0].any() and not db[h0 + hl:].any()
    with pytest.raises(ValueError, match="head range"):
        wm._check(qkv, bias, H, (3, 2))

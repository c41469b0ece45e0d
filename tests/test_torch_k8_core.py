"""PyTorch port, K8 on K1's design, on the CPU: packslim's key-blocked
online softmax (``window_msa_ablate.packslim_emulation``: 64 query rows a
pass against key blocks of 64, the running row max and sum, P in two bf16
terms for P v) against the plain version ``ablate_reference("packslim")``
within chip_smoke.py's BF16_TOL, and the sources' shape of the rebuild:
K8's phases are instantiations of K1's own kernel, K1's first CUDA-core
body is gone, and ``tools/ablate_k1.py`` still finds the lines it patches.

A CUDA kernel cannot run here; chip_smoke.py phase 15 holds every variant
against its plain version on the card and ``full`` against K1 bit for bit.
Pure torch (no JAX), one intra-op thread; inputs from numpy seeds.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402  (the card's bounds, one source of truth)
from infantposeestimation_gaussianbias_tpu_torch.kernels import (  # noqa: E402
    window_msa_ablate as ablate)
from infantposeestimation_gaussianbias_tpu_torch.tools import (  # noqa: E402
    ablate_k1)

CSRC = Path(ablate.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: several test processes share the CPU's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(nW, N, C, H, seed):
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(nW, N, 3 * C).astype(np.float32))
    bias = torch.from_numpy(rng.randn(H, N, N).astype(np.float32))
    return qkv.to(torch.bfloat16), bias


# (nW, N, C, H): the probe's default shape's windows (hd 32, G = 4, G*N =
# 196: four query passes, four key blocks, the last of four rows), padded
# groups (nW % G != 0), hrformer_base b0 (hd 39, G = 3, 147 rows) and b3
# (hd 39, 16 heads), hd 16 (G = 8, 128 rows: two whole key blocks)
SHAPES = [(12, 49, 32, 1), (10, 49, 32, 1), (7, 49, 78, 2), (5, 49, 624, 16),
          (9, 16, 32, 2)]


@pytest.mark.parametrize("nW,N,C,H", SHAPES)
def test_packslim_emulation_matches_reference(nW, N, C, H):
    qkv, bias = _inputs(nW, N, C, H, seed=nW + N + C)
    G = ablate.pack_factor(H, C, N)
    pbias = ablate.packed_bias(bias, G)
    got = ablate.packslim_emulation(qkv, pbias, H)
    ref = ablate.ablate_reference("packslim", qkv, pbias, H)
    assert got.dtype == torch.bfloat16 and got.shape == (nW, N, C)
    torch.testing.assert_close(got.float(), ref.float(),
                               atol=chip_smoke.BF16_TOL,
                               rtol=chip_smoke.BF16_TOL)


def test_packslim_masked_blocks_carry_no_weight():
    """The online softmax over all G*N keys equals the windows' own
    softmax: the -1e30 blocks it computes (and does not skip) weigh
    nothing once a row's real maximum has been seen."""
    nW, N, C, H = 8, 49, 32, 1
    qkv, bias = _inputs(nW, N, C, H, seed=5)
    pbias = ablate.packed_bias(bias, ablate.pack_factor(H, C, N))
    got = ablate.packslim_emulation(qkv, pbias, H)
    full = ablate.ablate_reference("full", qkv, bias, H)
    torch.testing.assert_close(got.float(), full.float(),
                               atol=chip_smoke.BF16_TOL,
                               rtol=chip_smoke.BF16_TOL)


def test_k8_phases_are_k1s_kernel():
    """K8's variants 0-3 launch K1's kernel template (the header both .cu
    files include), its `full` the very instantiation K1 launches; K1's
    first CUDA-core body is gone and nothing includes it."""
    ablate_src = (CSRC / "window_msa_ablate.cu").read_text()
    k1_src = (CSRC / "window_msa.cu").read_text()
    assert '#include "window_msa_fwd.cuh"' in ablate_src
    assert '#include "window_msa_fwd.cuh"' in k1_src
    assert "launch<bf16, Layout::kFlatQkv, P>" in ablate_src
    assert "launch_phase<kFull>" in ablate_src
    assert not (CSRC / "window_msa_body.cuh").exists()
    for src in CSRC.iterdir():
        assert "window_msa_body" not in src.read_text(), src.name


def test_ablate_k1_patches_the_kernel(tmp_path):
    """tools/ablate_k1.py patches K1's kernel in a copy of the package:
    every line it replaces is still there once (it raises otherwise)."""
    root = ablate_k1.patched_copy(tmp_path / "k1_ablation")
    text = (root / ablate_k1.PACKAGE.name / ablate_k1.SOURCE).read_text()
    assert text.count(ablate_k1.ENV) == 2 and "int wpb, int mode)" in text

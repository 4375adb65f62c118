"""CUDA kernels K1 (fog march) and K2 (SVO cast) against their plain
PyTorch versions, on the card. Every test skips when torch sees no CUDA
device (decided inside the fixture, not at import).

Run on the card from the repository root:
    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from voxtracer_torch.core.spectra import fog_density
from voxtracer_torch.kernels import fog, traverse
from voxtracer_torch.world import svo, worldgen

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,steps", [(1, 64), (100, 16), (1000, 64),
                                     (65536, 64)])
def test_fog_march_matches_plain(cuda, B, steps):
    rng = np.random.default_rng(B)
    start = torch.as_tensor(rng.random((B, 3), np.float32) * 1024, device=cuda)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=cuda)
    dens = fog_density(torch.as_tensor(rng.random(B, np.float32), device=cuda))
    y0 = torch.as_tensor(-np.log(1 - rng.random(B, np.float32)), device=cuda)
    before = fog.launches
    code_k, t_k = fog.fog_march(start, d, dens, y0, n_steps=steps)
    assert fog.launches == before + 1
    code_p, t_p = fog.fog_march_plain(start, d, dens, y0, n_steps=steps)
    torch.cuda.synchronize()
    assert torch.equal(code_k, code_p)
    assert torch.equal(t_k, t_p)  # both without FMA, same expression order


def test_fog_march_rejects_bad_input(cuda):
    x = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        fog.fog_march(x, x, torch.zeros(4, device=cuda, dtype=torch.float64),
                      torch.zeros(4, device=cuda))


@pytest.fixture(scope="module")
def world(cuda):
    dev = worldgen.generate(log2_size=7, verbose=False, device=cuda).serialize()
    return svo.upload(dev.table, dev.root, dev.height, cuda)


@pytest.mark.parametrize("kind", ["random", "capped", "active"])
def test_svo_cast_matches_plain_bit_for_bit(cuda, world, kind):
    rng = np.random.default_rng(7)
    B = 32768
    n = float(1 << world.height)
    start = torch.as_tensor(rng.random((B, 3), np.float32) * n, device=cuda)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[: B // 16, 1] = 0.0
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=cuda)
    dist = torch.full((B,), traverse.FAR, device=cuda)
    active = None
    if kind != "random":
        dist = torch.as_tensor(rng.random(B, np.float32) * n, device=cuda)
    if kind == "active":
        active = torch.as_tensor(rng.random(B) < 0.5, device=cuda)
    w = (world.table, world.root, world.height)
    before = traverse.launches
    k = traverse.svo_raycast(*w, start, d, dist, active=active)
    assert traverse.launches == before + 1
    p = traverse.svo_raycast_plain(*w, start, d, dist, active=active)
    torch.cuda.synchronize()
    for key in ("hit", "t", "node", "normal", "voxel"):
        assert torch.equal(k[key], p[key]), key
    assert k["hit"].any()

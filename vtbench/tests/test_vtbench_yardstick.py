"""K9's least time counts only what the work fixes: the paths, the
bounces they take, the marches x ``fog_steps`` and the pack's sectors
that the paths read."""

import numpy as np
import torch

from vtbench.reference import terrain
from vtbench.yardstick import k9, peaks


def test_least_time_depends_only_on_the_work():
    base = dict(paths=1000, bounces=3000, marches=5000, fog_steps=64,
                pack_bytes=1 << 20, lut_bytes=k9.LUT_BYTES)
    ops_s, bytes_s = k9.times(**base)
    ops = 3000 * k9.BOUNCE_OPS + 5000 * 64 * k9.SEGMENT_OPS
    nbytes = 1000 * k9.PATH_BYTES + (1 << 20) + k9.LUT_BYTES
    assert (ops_s, bytes_s) == (ops / peaks.FP32_FLOPS,
                                nbytes / peaks.HBM_BYTES)
    # marches x fog_steps is what counts, not either alone
    a = k9.times(**dict(base, marches=5000, fog_steps=64))
    b = k9.times(**dict(base, marches=10000, fog_steps=32))
    assert a == b
    # the bytes move with the paths and the pack's sectors read alone
    assert k9.times(**dict(base, bounces=10**9, marches=10**8))[1] == bytes_s
    assert k9.times(**dict(base, pack_bytes=2 << 20))[1] > bytes_s
    # more bounces or more marches never lower the operations
    assert k9.times(**dict(base, bounces=10**9))[0] > ops_s
    assert k9.times(**dict(base, marches=10**8))[0] > ops_s


def test_the_walk_marks_the_sectors_it_reads():
    """A 2^6 heightfield: a ray that climbs away from the terrain reads
    fewer sectors than one down into it, two rays at least as many as
    one, every mark lies in the pack, and a lane that is not active makes
    none."""
    log2 = 6
    n = 1 << log2
    h = np.random.default_rng(7).integers(
        8, 24, (n, n)).astype(np.uint32)
    tiles, offsets, height = terrain.build_height_mips(h)
    hmax = terrain.terrain_max(tiles, offsets)

    def marks(start, d, active=None):
        touched = terrain.pack_sectors(tiles)
        start = torch.tensor(start, dtype=torch.float32)
        d = torch.nn.functional.normalize(
            torch.tensor(d, dtype=torch.float32), dim=1)
        dist = torch.full((d.shape[0],), 1e30)
        terrain.hf_raycast_plain(tiles, offsets, height, start, d, dist,
                                 active=active, hmax_w=hmax, touched=touched)
        return touched

    up = marks([[1.5, 60.0, 1.5]], [[1.0, 0.2, 1.0]])
    down = marks([[1.5, 40.0, 1.5]], [[1.0, -0.4, 0.9]])
    assert up.sum() < down.sum()
    many = marks([[1.5, 40.0, 1.5], [62.5, 40.0, 62.5]],
                 [[1.0, -0.4, 0.9], [-0.9, -0.3, -1.0]])
    assert 0 < down.sum() < many.sum() <= terrain.pack_sectors(tiles).numel()
    assert bool((many | down).eq(many).all())  # the one ray's marks stay
    idle = marks([[1.5, 40.0, 1.5]], [[1.0, -0.4, 0.9]],
                 active=torch.tensor([False]))
    assert idle.sum() == 0
    assert tiles.numel() == terrain.pack_sectors(tiles).numel() \
        * terrain.SECTOR_FLOATS

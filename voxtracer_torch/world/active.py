"""Active-set box soup: the per-pose culled view of a box soup.

The port of ``voxtracer/world/active.py`` in plain PyTorch on the soup's
device. A terrain soup is mostly boxes no primary ray of the current
pose can reach. ``ActiveSoup`` keeps the full soup resident and hands the
rasterizer a compacted *active subset*: boxes that could be hit by any
ray from cameras near the current pose. The subset is refreshed only
when the camera leaves the validity volume of the last cull.

Conservativeness (the exactness contract): a box is culled only if its
bounding sphere lies outside an INFLATED frustum, the view frustum
widened by ``margin_deg`` on every side AND pushed outward by the full
translation budget on every plane, and outside a ``keep_radius`` ball
around the camera; with a heightmap, also a box that the horizon tables
prove hidden for every camera within ``occl_slack`` (world/occlusion.py).
A later pose that has translated less than the budget and rotated less
than ``margin_deg/2`` casts every primary ray inside that inflated
frustum, so culled boxes cannot be first hits, and the active-soup
raster frame equals the full-soup frame in every output. The subset
keeps the full soup's relative order, since soup order breaks raster
ties. Bounce and shadow rays must NOT use the active set.

The JAX package sizes the subset to a static capacity (``cap="auto"``,
grown on overflow). PyTorch needs no static shape: the subset is sized
exactly from one host read of its count per cull. An explicit integer
``cap`` keeps the JAX rule: a pose whose subset would exceed it is served
the full soup (``overflowed``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from voxtracer_torch.core.vecmath import sqrt
from voxtracer_torch.world import occlusion as occ


def _cull(box_lo, box_size, box_attr, cam_pos, basis, fx: float, fy: float,
          keep_r: float, trans_r: float, occl=None, nd: int = 0,
          occl_slack: float = 0.0, pool: int = 32):
    """Conservative frustum (and horizon) cull with compaction.

    box_lo/box_size int32 (M, 3), box_attr float32 (M, 4) on one device;
    cam_pos (3,) and basis (3, 3) host arrays; ``occl``: the pose's
    ``occlusion.build_horizon`` tables or None. Returns the kept rows
    ``(lo, size, attr)`` in soup order and their count (one host read).

    The camera-space transform is three dot products written out in full
    float32: a TF32 matmul would put voxels of error at 8192-scale
    coordinates into the conservative margin."""
    lo_f = box_lo.to(torch.float32)
    half_f = box_size.to(torch.float32) * 0.5
    c = lo_f + half_f  # centre
    r = sqrt(half_f[:, 0] ** 2 + half_f[:, 1] ** 2 + half_f[:, 2] ** 2)
    cam = np.asarray(cam_pos, np.float32)
    b = np.asarray(basis, np.float32)
    rel = [c[:, i] - float(cam[i]) for i in range(3)]
    vx, vy, vz = (rel[0] * float(b[0, j]) + rel[1] * float(b[1, j])
                  + rel[2] * float(b[2, j]) for j in range(3))
    # inflated side planes |vx| <= vz*fx (+ slack): the slack covers the
    # bounding sphere and the reuse window's translation budget; a plane
    # normal has norm sqrt(1 + f^2)
    slack = r + trans_r
    sx = slack * math.sqrt(1.0 + fx * fx)
    sy = slack * math.sqrt(1.0 + fy * fy)
    in_frustum = ((vz * fx + sx >= vx) & (vz * fx + sx >= -vx)
                  & (vz * fy + sy >= vy) & (vz * fy + sy >= -vy)
                  & (vz + slack >= 0.0))
    near = sqrt(rel[0] ** 2 + rel[1] ** 2 + rel[2] ** 2) <= keep_r + r
    keep = in_frustum | near
    if occl is not None:
        hidden = occ.hidden_mask(occl, c, half_f, cam, occl_slack, nd, pool)
        keep = (in_frustum & ~hidden) | near
    idx = torch.nonzero(keep).squeeze(1)
    return box_lo[idx], box_size[idx], box_attr[idx], int(idx.numel())


class ActiveSoup:
    """The full soup on its device plus a lazily refreshed active subset.

    ``active(cam_pos, basis)`` returns (box_lo, box_size, box_attr) for
    kernels/raster.py, re-culling only when the camera leaves the last
    cull's validity volume (``_valid_for``)."""

    def __init__(self, soup, width_px: int, height_px: int, cap=None,
                 margin_deg: float = 12.0, keep_radius: float = 128.0,
                 heights=None):
        """``soup``: (box_lo, box_size, box_attr) tensors as
        ``raster.soup_to_device`` makes them. ``heights``: the (n, n)
        terrain heightmap of an unedited world, which adds the horizon
        occlusion cull (world/occlusion.py). ``cap``: None sizes the
        subset exactly; an integer serves the full soup to a pose whose
        subset is larger."""
        self._lo, self._size, self._attr = soup
        self._hmin2 = None
        self._nd = 0
        self._pool = 32
        if heights is not None:
            n = np.asarray(heights).shape[0]
            # the pool scales with the world so the cull's reach stays
            # proportional: 16 at 8192^3, 4 at 1024^3 and below
            self._pool = max(4, n // 512)
            if n % self._pool == 0 and n >= self._pool * 8:
                self._hmin2 = torch.from_numpy(occ.min_pool_heights(
                    np.asarray(heights), self._pool)).to(self._lo.device)
                # radial reach: the world's diagonal (+1 for strict
                # indexing)
                self._nd = int(np.ceil(n * 1.5 / self._pool)) + 1
        # occlusion validity budget: far smaller than keep_radius/2, since
        # slack widens every box's angular range and slope bounds
        self.occl_slack = float(max(4, self._pool))
        self.cap = cap
        self.margin = math.radians(margin_deg)
        self.keep_radius = float(keep_radius)
        # the frustum's half-extent tangents (camera.pixel_ndc), inflated
        # by the angular margin
        hx = (width_px - 1) / height_px
        self._fx = math.tan(min(math.atan(hx) + self.margin, 1.55))
        self._fy = math.tan(min(math.atan(1.0) + self.margin, 1.55))
        self._pose = None  # (pos, basis) of the last cull
        self._rows = None
        self.n_active = 0

    def _trans_budget(self) -> float:
        if self._hmin2 is not None:
            return min(self.keep_radius / 2, self.occl_slack)
        return self.keep_radius / 2

    def _valid_for(self, cam_pos, basis) -> bool:
        if self._pose is None:
            return False
        p0, b0 = self._pose
        if np.linalg.norm(cam_pos - p0) > self._trans_budget():
            return False
        # rotation between the bases: the largest angle any view
        # direction moved
        dot = float(np.clip((np.trace(basis.T @ b0) - 1) / 2, -1.0, 1.0))
        return math.acos(dot) <= self.margin / 2

    def active(self, cam_pos, basis):
        """The rows for a camera at ``cam_pos`` with ``basis`` (host
        arrays or tensors): the last cull's while the pose is inside its
        validity volume, else a new cull's."""
        cam_pos = np.asarray(cam_pos, np.float32).reshape(3)
        if isinstance(basis, torch.Tensor):
            basis = basis.detach().cpu().numpy()
        basis = np.asarray(basis, np.float32)
        if not self._valid_for(cam_pos, basis):
            budget = self._trans_budget()
            occl = None
            if self._hmin2 is not None:
                occl = occ.build_horizon(self._hmin2, cam_pos,
                                         self.occl_slack, self._nd,
                                         self._pool)
            lo, size, attr, self.n_active = _cull(
                self._lo, self._size, self._attr, cam_pos, basis, self._fx,
                self._fy, self.keep_radius, budget, occl=occl, nd=self._nd,
                occl_slack=budget, pool=self._pool)
            if self.overflowed:
                self._rows = (self._lo, self._size, self._attr)
            else:
                self._rows = (lo, size, attr)
            self._pose = (cam_pos.copy(), basis.copy())
        return self._rows

    @property
    def overflowed(self) -> bool:
        return self.cap is not None and self.n_active > self.cap

"""Hash-consed sparse voxel octree (SVO/DAG) and its device upload.

The host-side builder/editor is the port's own copy of
``voxtracer/world/svo.py`` (numpy only; behavioural reference src/svo.rs):
identical subtrees share one node, nodes are reference-counted, point
edits path-copy the spine. ``serialize`` flattens it to a uint32
``[capacity, 8]`` table: interior rows hold 8 child slots (EMPTY for an
absent octant), leaf rows hold the RGB albedo as three float32 bit
patterns. Octant child index: bit0 = x, bit1 = y, bit2 = z. After a first
``serialize`` the space tracks the slots each edit allocates or frees,
and ``serialize_delta`` hands out only those rows.

``upload`` turns any object with numpy ``.table/.root/.height`` — this
module's ``DeviceSvo`` or the JAX package's — into a ``DeviceWorld`` on a
torch device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

EMPTY = 0xFFFFFFFF  # empty-octant / no-node sentinel in the device table

_BLOCK = 0  # cell kinds
_CHILDREN = 1


def _f32_bits(v: float) -> int:
    return int(np.float32(v).view(np.uint32))


def _bits_f32(b: int) -> float:
    return float(np.uint32(b).view(np.float32))


class SvoSpace:
    """Mutable hash-consed SVO. Node ids are slot indices (freed slots are
    reused), so ``capacity`` — the device-table length — stays compact."""

    def __init__(self):
        self._intern = {}  # cell key -> node id
        self._kind = []  # node id -> _BLOCK | _CHILDREN | None (free)
        self._payload = []  # node id -> (r,g,b) u32 bits | tuple of 8 child ids
        self._refcount = []
        self._level = []
        self._solid = []  # node id -> uniform solid-leaf id | -1
        self._free = []
        # slots allocated or freed since the last serialize/serialize_delta,
        # tracked once a first serialize exists (_synced)
        self._dirty: set = set()
        self._synced = False
        self.edited = False  # any mutating point edit since construction
        self.edit_count = 0  # mutating point edits
        self.set_calls = 0  # set() calls, no-ops included
        self.root: Optional[int] = None

    def _alloc(self, kind, payload, level) -> int:
        if self._free:
            nid = self._free.pop()
            self._kind[nid] = kind
            self._payload[nid] = payload
            self._refcount[nid] = 0
            self._level[nid] = level
        else:
            nid = len(self._kind)
            self._kind.append(kind)
            self._payload.append(payload)
            self._refcount.append(0)
            self._level.append(level)
            self._solid.append(-1)
        if self._synced:
            self._dirty.add(nid)
        return nid

    def create_block(self, rgb) -> int:
        """Intern a leaf node with the given RGB albedo (float32 exact)."""
        key = (_BLOCK, _f32_bits(rgb[0]), _f32_bits(rgb[1]), _f32_bits(rgb[2]))
        nid = self._intern.get(key)
        if nid is None:
            nid = self._alloc(_BLOCK, key[1:], 0)
            self._solid[nid] = nid
            self._intern[key] = nid
        return nid

    def create_children(self, children) -> Optional[int]:
        """Intern an interior node; all-empty children collapse to None
        (svo.rs:47-49). Child refcounts are bumped on first insert."""
        children = tuple(children)
        assert len(children) == 8
        if all(c is None for c in children):
            return None
        key = (_CHILDREN, children)
        nid = self._intern.get(key)
        if nid is None:
            level = 0
            for c in children:
                if c is not None:
                    self._refcount[c] += 1
                    level = max(level, self._level[c] + 1)
            nid = self._alloc(_CHILDREN, children, level)
            # a subtree that is solid with one colour throughout: children
            # never change once interned, so this is set once
            if all(c is not None for c in children):
                sl = self._solid[children[0]]
                if sl >= 0 and all(self._solid[c] == sl
                                   for c in children[1:]):
                    self._solid[nid] = sl
            self._intern[key] = nid
        return nid

    def _decr(self, nid: int):
        self._refcount[nid] -= 1
        if self._refcount[nid] == 0:
            if self._kind[nid] == _BLOCK:
                key = (_BLOCK,) + self._payload[nid]
            else:
                key = (_CHILDREN, self._payload[nid])
            del self._intern[key]
            kind, payload = self._kind[nid], self._payload[nid]
            self._kind[nid] = None
            self._payload[nid] = None
            self._solid[nid] = -1
            self._free.append(nid)
            if self._synced:
                self._dirty.add(nid)
            if kind == _CHILDREN:
                for c in payload:
                    if c is not None:
                        self._decr(c)

    def set_root(self, node: Optional[int]):
        if node is not None:
            self._refcount[node] += 1
        if self.root is not None:
            self._decr(self.root)
        self.root = node

    def height(self) -> int:
        return 0 if self.root is None else self._level[self.root]

    def capacity(self) -> int:
        return len(self._kind)

    def num_nodes(self) -> int:
        return len(self._kind) - len(self._free)

    def nodes(self):
        """Iterate (node_id, cell) over live nodes (svo.rs:150-152); cell
        is ('block', (r, g, b)) or ('children', (8 ids or None))."""
        for nid, kind in enumerate(self._kind):
            if kind is not None:
                yield nid, self.get_node(nid)

    def get_node(self, nid: int):
        """Cell of a live node (svo.rs:154-156)."""
        kind = self._kind[nid]
        if kind is None:
            raise ValueError(f"node {nid} is not live")
        if kind == _BLOCK:
            r, g, b = self._payload[nid]
            return ("block", (_bits_f32(r), _bits_f32(g), _bits_f32(b)))
        return ("children", self._payload[nid])

    def root_node(self) -> Optional[int]:
        return self.root

    def unwrap_children(self, nid: int):
        """Children tuple of an interior node (svo.rs:172-178)."""
        if self._kind[nid] != _CHILDREN:
            raise ValueError(f"node {nid} is not an interior node")
        return self._payload[nid]

    def get(self, p):
        """Point query: colour of the voxel at integer coords p, or None."""
        x, y, z = int(p[0]), int(p[1]), int(p[2])
        node = self.root
        for level in range(self.height() - 1, -1, -1):
            if node is None:
                return None
            c = 1 << level
            idx = (x >= c) | ((y >= c) << 1) | ((z >= c) << 2)
            node = self._payload[node][idx]
            x -= c if x >= c else 0
            y -= c if y >= c else 0
            z -= c if z >= c else 0
        if node is None:
            return None
        r, g, b = self._payload[node]
        return (_bits_f32(r), _bits_f32(g), _bits_f32(b))

    def leaf_at(self, p) -> Optional[int]:
        """Slot of the block leaf at p (its row in the device table), or
        None for air."""
        x, y, z = int(p[0]), int(p[1]), int(p[2])
        node = self.root
        for level in range(self.height() - 1, -1, -1):
            if node is None:
                return None
            c = 1 << level
            idx = (x >= c) | ((y >= c) << 1) | ((z >= c) << 2)
            node = self._payload[node][idx]
            x -= c if x >= c else 0
            y -= c if y >= c else 0
            z -= c if z >= c else 0
        return node

    def set(self, p, rgb: Optional[tuple]):
        """Path-copying point edit: place a block (rgb) or clear (None)
        inside [0, 2^height)^3 (svo.rs:102-144). ``set_calls`` counts every
        call, ``edit_count`` the ones that change the world; a change sets
        ``edited`` and clears ``heights_exact`` (the renderer re-proves it
        for edits that keep the world a heightfield)."""
        x, y, z = int(p[0]), int(p[1]), int(p[2])
        n = 1 << self.height()
        if not (0 <= x < n and 0 <= y < n and 0 <= z < n):
            raise ValueError(f"voxel {(x, y, z)} outside [0, {n})^3")
        self.set_calls += 1
        stack = []
        node = self.root
        for level in range(self.height() - 1, -1, -1):
            c = 1 << level
            idx = (x >= c) | ((y >= c) << 1) | ((z >= c) << 2)
            stack.append((node, idx))
            if node is not None:
                node = self._payload[node][idx]
            x -= c if x >= c else 0
            y -= c if y >= c else 0
            z -= c if z >= c else 0
        if node is not None:
            if rgb is not None and self._payload[node] == tuple(
                    _f32_bits(v) for v in rgb):
                return
        elif rgb is None:
            return
        self.edited = True
        self.heights_exact = False
        self.edit_count += 1
        new_node = self.create_block(rgb) if rgb is not None else None
        while stack:
            nd, idx = stack.pop()
            children = list(self._payload[nd]) if nd is not None else [None] * 8
            children[idx] = new_node
            new_node = self.create_children(children)
        if new_node is not None:
            self._refcount[new_node] += 1
        if self.root is not None:
            self._decr(self.root)
        self.root = new_node

    def serialize(self) -> "DeviceSvo":
        """Flatten to the uint32 node table (fragment.rs:274-290): leaves
        write float32 RGB bit patterns into columns 0..3, interior nodes
        child slots with EMPTY for absent octants, dead slots stay EMPTY."""
        cap = max(self.capacity(), 1)
        table = np.full((cap, 8), EMPTY, dtype=np.uint32)
        for nid, kind in enumerate(self._kind):
            self._write_row(table[nid], nid, kind)
        solid = np.full((cap,), -1, dtype=np.int32)
        solid[:len(self._solid)] = self._solid
        root = EMPTY if self.root is None else self.root
        self._dirty.clear()
        self._synced = True
        return DeviceSvo(table=table, root=root, height=self.height(),
                         solid_leaf=solid, space=self)

    def _write_row(self, row, nid, kind):
        if kind == _BLOCK:
            row[:3] = self._payload[nid]
        elif kind == _CHILDREN:
            for i, c in enumerate(self._payload[nid]):
                if c is not None:
                    row[i] = c

    def serialize_delta(self):
        """The rows changed since the last ``serialize`` or
        ``serialize_delta``: ``(rows int64[K] ascending, vals uint32[K, 8],
        solid int32[K], root, height, capacity)``, or None before a first
        ``serialize``. Freed slots come as all-EMPTY rows, so the delta
        applied to the last table gives ``serialize``'s table exactly."""
        if not self._synced:
            return None
        rows = np.array(sorted(self._dirty), dtype=np.int64)
        vals = np.full((len(rows), 8), EMPTY, dtype=np.uint32)
        solid = np.full((len(rows),), -1, dtype=np.int32)
        for k, nid in enumerate(rows):
            self._write_row(vals[k], nid, self._kind[nid])
            solid[k] = self._solid[nid]
        self._dirty.clear()
        root = EMPTY if self.root is None else self.root
        return rows, vals, solid, root, self.height(), self.capacity()

    def mem_usage(self) -> int:
        """Rough bytes estimate (table + intern map), for worldgen logs."""
        return self.capacity() * 8 * 4 + len(self._intern) * 96


@dataclass
class DeviceSvo:
    """Flat SVO on the host: ``table`` uint32[capacity, 8], ``root`` slot
    index or EMPTY, ``height`` tree height (world edge = 2^height),
    ``solid_leaf`` int32[capacity] the leaf of each subtree that is solid
    with one colour (else -1; world/boxes.py emits such a subtree as one
    box), ``space`` the space that serialized it (world/boxes.py reads its
    terrain heightmap)."""

    table: np.ndarray
    root: int
    height: int
    solid_leaf: Optional[np.ndarray] = None
    space: object = None

    def leaf_colors(self):
        """float32[capacity, 3] view of the leaf RGB bit patterns."""
        return np.ascontiguousarray(self.table[:, :3]).view(np.float32)


def from_dense(grid_solid: np.ndarray, grid_rgb: np.ndarray) -> SvoSpace:
    """Build an SvoSpace from a dense cubic grid (test and edit-scale
    worlds), ``voxtracer/world/svo.py:from_dense`` step for step, so the
    slots and the serialized table are the JAX package's by bits.

    grid_solid: bool[N, N, N] (N a power of two), grid_rgb: float32[N, N,
    N, 3], both indexed [x, y, z]. Bottom-up: the leaves are the distinct
    colours in ``np.unique`` order, then each level's distinct child rows
    in ``np.unique`` order, children in the order x | y<<1 | z<<2."""
    n = grid_solid.shape[0]
    if n < 2 or n & (n - 1) or grid_solid.shape != (n, n, n):
        raise ValueError(f"from_dense: grid {grid_solid.shape} is not a cube "
                         "of a power-of-two edge >= 2")
    space = SvoSpace()
    ids = np.full(grid_solid.shape, -1, dtype=np.int64)
    solid_idx = np.argwhere(grid_solid)
    colors = grid_rgb[grid_solid]
    color_bits = colors.astype(np.float32).view(np.uint32).reshape(-1, 3)
    uniq, inv = np.unique(color_bits, axis=0, return_inverse=True)
    leaf_ids = np.array([space.create_block(tuple(u.view(np.float32)))
                         for u in uniq], dtype=np.int64)
    if len(solid_idx):
        ids[tuple(solid_idx.T)] = leaf_ids[inv.reshape(-1)]
    level_ids = ids
    while level_ids.shape[0] > 1:
        m = level_ids.shape[0] // 2
        octs = np.stack([level_ids[ox::2, oy::2, oz::2]
                         for oz in (0, 1) for oy in (0, 1) for ox in (0, 1)],
                        axis=-1)  # (m, m, m, 8) in child-index order
        flat = octs.reshape(-1, 8)
        nonempty = (flat != -1).any(axis=1)
        new_ids = np.full(m * m * m, -1, dtype=np.int64)
        if nonempty.any():
            uniq_rows, inv_rows = np.unique(flat[nonempty], axis=0,
                                            return_inverse=True)
            created = np.array([space.create_children(
                [None if c == -1 else int(c) for c in row])
                for row in uniq_rows], dtype=np.int64)
            new_ids[nonempty] = created[inv_rows.reshape(-1)]
        level_ids = new_ids.reshape(m, m, m)
    root = None if level_ids[0, 0, 0] == -1 else int(level_ids[0, 0, 0])
    space.set_root(root)
    return space


@dataclass
class DeviceWorld:
    """The node table on a torch device: int32 (N, 8), EMPTY = -1, leaf
    columns 0..3 holding float32 RGB bits; ``root`` -1 for an empty world."""

    table: torch.Tensor
    root: int
    height: int


def upload(table_u32: np.ndarray, root: int, height: int, device) -> DeviceWorld:
    """Copy a serialized uint32 table to ``device`` as int32 rows."""
    table = np.ascontiguousarray(np.asarray(table_u32, np.uint32)).view(np.int32)
    root = int(root)
    return DeviceWorld(
        table=torch.from_numpy(table.copy()).to(device),
        root=-1 if root == EMPTY else root,
        height=int(height),
    )

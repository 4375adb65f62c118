"""K9's least time: the time the bounce loop (``trace_paths``, the
stage kernels of ``csrc/path_trace.cu``) could take at the card's peaks
for the work its paths define, whatever walk does it.

Only what the work itself fixes is counted, so no implementation of the
walk can move the yardstick:

* the paths (one a pixel a sample),
* the bounces they begin alive, which the result fixes (K9 equals the
  masked loop by bits, so a path's bounces are the reference's),
* the fog marches they define, along the path each bounce and toward the
  sun where a hit faces it, at ``fog_steps`` segments each,
* each path's input and output bytes, the spectral LUT once a call,
  and the heightfield pack's 32-byte sectors that the paths' casts read,
  each once a call: what these paths need, not the whole 260 MiB pack
  at 8192^3. The reference's walk (``reference/terrain.py``, the cells
  K4's arithmetic visits) marks them, so they move with the paths and
  not with the program's walk.

The casts' walk steps depend on the walk and are counted as nothing, so
this is a lower bound. It reads no counter of K9.

Operations a unit (float32 arithmetic and 32-bit integer operations
alike at the float32 rate; a transcendental or a square root as one;
counted from the reference's plain arithmetic, ``vtbench/reference/``):
"""

from vtbench.yardstick import peaks

# one segment of a fog march (atmosphere.fog_march_plain's loop body):
# the segment's ends 6, the altitude at its far end 13 (3 mul + 3 add
# for the point, 3 mul + 2 add, a root, a subtract), its density 3 (mul,
# exp, mul), the scatter test 1, the fraction 2, the scatter point 4,
# the running sum 2
SEGMENT_OPS = 31
# one live bounce beside its walks and marches: 11 random3 draws of 42
# (pcg3d's 36 integer operations, 3 shifts and converts, 3 scales),
# two planet spans of 44 (atmosphere._sphere_span), the sun sample 38,
# three cosine-hemisphere draws of 36 (two planet scatters, the bounce),
# NEE and the emissive rule 40, the bounce's throughput and the
# roulette 14, the choice of the nearer event and the move 18
BOUNCE_OPS = 11 * 42 + 2 * 44 + 38 + 3 * 36 + 40 + 14 + 18
# a path's inputs and outputs: RNG state in and out (12 + 12 B), its
# direction (12), wavelength (4), the first hit the primaries hand over
# (t 4, normal 12, hit 1), the radiance out (12)
PATH_BYTES = 12 + 12 + 12 + 4 + 4 + 12 + 1 + 12
LUT_BYTES = 2048 * 3 * 4  # the wavelength -> RGB table (spectra.LUT_SIZE)


def times(paths: float, bounces: float, marches: float, fog_steps: int,
          pack_bytes: int, lut_bytes: int):
    """(operations seconds, bytes seconds): the operations over the
    float32 peak and the bytes over the HBM bandwidth. The least time is
    the larger of the two."""
    ops = bounces * BOUNCE_OPS + marches * fog_steps * SEGMENT_OPS
    nbytes = paths * PATH_BYTES + pack_bytes + lut_bytes
    return ops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES

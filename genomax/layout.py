"""Shared tile-layout constants — the pack <-> kernel contract.

These values bind the packers (genomax/pack/bucketing.py) to the kernels
(genomax/kernels/wavefront.py, genomax/kernels/csrc/gx_cells.h): the
packers size and quantize the tile and stream buffers with them, and the
kernels' window reads assume those bounds. Import from here — never
redefine (gx_cells.h kLanes mirrors LANES).

Layout recap (full proofs in kernels/wavefront.py):

- x tiles are (NXs, LANES): sequence position on axis 0 ("sublanes"),
  LANES independent pairs on the last axis ("lanes").
- stream buffers are (NDs, LANES) with the sequence REVERSED around
  the anchor A = NDs - NXs: sy[k] sits at row A - 1 - k, pads
  (PAD_STREAM) below row A - len. The kernels' per-diagonal window
  load is rows [A - d, A - d + NXs); the packers guarantee
  A >= ceil(n_diags/unroll)*unroll for any unroll <= MAX_UNROLL, and
  quantize A to STREAM_CHUNK, which bounds the number of distinct stream
  shapes (compilations).
"""

LANES = 128  # pairs per tile
SUB_Q = 8  # padding quantum of the position axis
MAX_UNROLL = 32  # largest unroll the packs reserve anchor slack for
STREAM_CHUNK = 256  # stream-anchor quantum

# Pad codes. x pads decay the DP state exactly (PAD_X mismatches
# everything, including PAD_STREAM); packers loudly reject bytes 0/1
# inside real sequences.
PAD_X = 1
PAD_STREAM = 0

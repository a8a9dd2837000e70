"""The ARD Gram kernel and its backward: CUDA C++ on a CUDA tensor, plain
PyTorch on a CPU tensor.

Port of `gpscore/ops/gram_pallas.py` (the fused Pallas Gram tile
``_gram_kernel`` and the custom VJP ``_fwd``/``_bwd`` around it). The kernels
are in ``gpscore_torch/csrc/gram.cu``; :mod:`gpscore_torch.ops._build`
compiles them at first use.

As in the Pallas version, the inputs are scaled by the inverse lengthscale
outside the kernel, xs = x / l and xps = x' / l, and the kernel computes

    K = sig * exp(-1/2 |xs_i - xps_j|^2).

:class:`ArdGram` saves only the O(nd) scaled inputs; its backward recomputes K
inside the kernels and returns, with W = g * K,

    d_xs = sum_j W_ij (xps_j - xs_i),   d_xps = sum_i W_ij (xs_i - xps_j),
    d_log_sig = sum W,

chained through 1/l into d_x, d_xp and d_log_len by O(nd) tensor code here,
as `gram_pallas.py:127-132` does.

Element types: float32, or float64 throughout (inputs, K, the cotangent and
every output; the kernels' fp64 instantiations, through the ``*_f64`` entry
points). Any d >= 1: past MAX_D features (fp64: MAX_D / 2) a call takes the
kernels' d-chunked builds (csrc/gram.cu), which sum the squared distance
over every stage of d before the exp: the forward's under
:func:`fwd_dchunk_plan` (a kernel of its own, counted as "fwd_dchunk"); the
backward's stage tiles of pairs in shared memory and form W once per pair,
under :func:`dchunk_plan`. Nothing casts and nothing falls back: a CUDA tensor of
another dtype raises.

Dispatch is by device alone: a CPU tensor takes the plain version (the
cross-term form of `gpscore/ops/kernels.py:28-40,54-64`, so CPU results track
the JAX package), a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches, so a run can show that it went through the kernels;
a loop that replays a captured CUDA graph adds its replays with
:func:`add_launches`. While torch.profiler records, each call of the two
dispatchers, :func:`gram_fwd` and :func:`gram_bwd`, is a span of its own
(``gram.fwd``, ``gram.bwd``; :func:`gpscore_torch.utils.profiling.span`), on
the CPU too, timed by CUDA events on a card.

A leading batch axis, the counterpart of a ``pl.pallas_call`` under
``jax.vmap`` (which gets an extra grid axis from Pallas's batching rule):
xs [B, n, d], xps [B, m, d], sig [B] and g [B, n, m] give K [B, n, m] in one
launch, each batch's Gram independent of the others and bitwise what an
unbatched launch on its inputs gives. An input may also come unbatched
beside batched ones (xs [n, d], sig one value): every batch shares it, at a
batch stride of 0. A call with no 3-D input is the unbatched call. The
kernels take at most ``_build.MAX_BATCH`` Grams a launch (the grid's z
extent); a call of more launches them in consecutive chunks
(:func:`_build.batch_chunks`), each planned as a call of its own size, so a
call of at most MAX_BATCH is one launch and every Gram of a larger call is
computed as in a call of its chunk alone.

Each plan type names its C entry point (``entry``), its ``LAUNCHES`` key and
the workspace it needs, and gives the entry's arguments in the order of
``_build.SIGNATURES`` (``args``); :func:`_launch_plan` launches any plan.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gpscore_torch.ops import _build
from gpscore_torch.utils import profiling

# Kernel launches by kernel: a wrapper adds one where it launches, and
# add_launches adds the replays of a graph that captured such launches.
# The d-chunked forward is a kernel of its own ("fwd_dchunk"); the d-chunked
# backward's launches count under its halves.
LAUNCHES = {"fwd": 0, "bwd_rows": 0, "bwd_cols": 0, "fwd_dchunk": 0}
# The widest d of the unchunked fp32 backward (csrc/gram.cu kMaxD), and the
# d-chunk of the chunked builds: 256 bytes, 64 floats or 32 doubles.
MAX_D = 64
DTYPES = _build.DTYPES
THREADS = 256  # threads per block of every kernel (kThreads)
COLS_TILE = 32  # gram_bwd_cols: columns per block (csrc/gram.cu kColsTile)
COLS_STAGE_ROWS = 64  # gram_bwd_cols: rows per shared-memory stage (kColsStageRows)
ROWS_MAX_STEP = 256  # gram_bwd_rows: most columns a block takes per trip (32 lanes x 8 warps)
ROWS_MIN_STEP = 4  # gram_bwd_rows: fewest columns a block takes per trip, where m allows
ROWS_STAGE_FLOATS = 8192  # gram_bwd_rows: a shared-memory stage of xps rows and g tile, 32 KB
# (4096 elements in fp64: the stage's bytes, not its elements, are fixed)
ROWS_CHUNK_MIN_COLS = 1024  # gram_bwd_rows: fewest columns of a chunk, when there are several
FWD_COLS_PER_THREAD = 4  # gram_fwd: one float4 of a row per thread (kFwdColsPerThread)
FWD_COL_THREADS = (8, 16, 32, 64)  # gram_fwd: the column-thread counts it takes
FWD_ROWS_PER_THREAD = (8, 4, 2, 1)  # gram_fwd: its instantiations, most rows first

# The card's peaks for the roofline bound (NVIDIA's H100 SXM data sheet, dense,
# at the 700 W limit): device memory bandwidth; fp32 outside the tensor cores
# (wgmma has no IEEE fp32 mode); fp64 through the tensor cores (DMMA is IEEE
# fp64, so the card's fp64 peak, though the fp64 builds do not use it yet).
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12
H100_FP64_FLOP_PER_S = 67e12


def max_unchunked_d(elem: int = 4) -> int:
    """The widest d of the unchunked backward for ``elem``-byte elements
    (64 floats, 32 doubles: its registers hold 2 * DMAX elements a thread)
    and the d-chunk of the chunked builds; gram_fwd's unchunked build takes
    the same d."""
    return MAX_D * 4 // elem


def chunked(d: int, elem: int = 4) -> bool:
    """Whether a call on d features of ``elem``-byte elements takes the
    kernels' d-chunked builds: d past :func:`max_unchunked_d`."""
    return d > max_unchunked_d(elem)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(per_call, times: int) -> None:
    """Count ``times`` replays of a CUDA graph whose capture launched
    ``per_call`` ({kernel: launches}): a replay runs the kernels without
    passing through their wrappers."""
    for k, v in per_call.items():
        LAUNCHES[k] += v * times


class Roofline(NamedTuple):
    """The least time an H100 could take for one call's work."""

    bytes: int  # each input read once, each output written once
    flops: int
    bound_us: float  # the larger of bytes / bandwidth and flops / fp32 peak
    bound_by: str  # "bytes" or "operations"


def roofline(kernel: str, n: int, m: int, d: int, out_bytes: Optional[int] = None,
             diag: bool = False, batch: int = 1, shared_x: bool = False,
             elem: int = 4) -> Roofline:
    """Roofline bound of one call of ``kernel`` ("gram_fwd" or its d-chunked
    build "gram_fwd_dchunk", "gram_bwd_rows" or "gram_bwd_cols") at K of n x m on d inputs, ``batch`` such Grams in
    the call (bytes and FLOPs times ``batch``: every batch reads its own
    inputs). ``shared_x``: the call is K(x, x), one tensor given as both xs
    and xps (n == m), so x is read once.

    Bytes: xs [n, d], xps [m, d] and sig are read by all three; the backward
    kernels also read g [n, m]; outputs are K [n, m] (forward, ``out_bytes``
    an element: 2 for a bfloat16 or float16 K; with ``diag`` it also reads
    the diagonal's scalar), d_xs [n, d] and rowsum [n] (rows), d_xps [m, d]
    (columns). FLOPs per element of K: 3d + 3 for the forward (d differences
    and d FMAs, the scale, the exp and sig), 6d + 6 for either backward half
    (the forward's, W = g * K, the sum of W, d more differences and d more
    FMAs). ``elem``: the inputs' element size, 8 for a float64 call, whose
    FLOPs go at the card's fp64 rate (``out_bytes`` defaults to ``elem``)."""
    out_bytes = elem if out_bytes is None else out_bytes
    if shared_x and n != m:
        raise ValueError(f"shared_x needs a square K, not {n} x {m}")
    inputs = n * d + (0 if shared_x else m * d) + 1
    out = 0
    if kernel in ("gram_fwd", "gram_fwd_dchunk"):
        floats, flops = inputs + int(diag), (3 * d + 3) * n * m
        out = out_bytes * n * m
    elif kernel == "gram_bwd_rows":
        floats, flops = inputs + n * m + n * d + n, (6 * d + 6) * n * m
    elif kernel == "gram_bwd_cols":
        floats, flops = inputs + n * m + m * d, (6 * d + 6) * n * m
    else:
        raise ValueError(f"no roofline for kernel {kernel!r}")
    nbytes, flops = batch * (elem * floats + out), batch * flops
    peak = H100_FP64_FLOP_PER_S if elem == 8 else H100_FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
    return Roofline(nbytes, flops, max(t_bytes, t_ops) * 1e6,
                    "bytes" if t_bytes >= t_ops else "operations")


class FwdPlan(NamedTuple):
    """How ``gram_fwd`` tiles K: a block of THREADS threads is col_threads x
    (THREADS / col_threads); a thread owns FWD_COLS_PER_THREAD columns and
    rows_per_thread rows."""

    col_threads: int
    rows_per_thread: int
    launches: int  # kernel launches per call
    batch: int = 1

    entry, key, workspace = "gram_fwd", "fwd", None

    def args(self, ptrs, ws, n, m, d, size, strides, out_type):
        return (*ptrs, n, m, d, self.col_threads, self.rows_per_thread, out_type, size, *strides)


def fwd_plan(n: int, m: int, d: int, sms: int, batch: int = 1, elem: int = 4) -> FwdPlan:
    """The tiling of ``gram_fwd`` on a card with ``sms`` multiprocessors,
    for ``batch`` Grams in one launch, of ``elem``-byte elements; past
    ``max_unchunked_d(elem)`` the d-chunked kernel's, :func:`fwd_dchunk_plan`
    (a :class:`FwdDchunkPlan`).

    A block stages (rows_tile + col_tile) x d elements, at most 288 x 256
    bytes = 72 KB in either type, so two blocks fit an SM at every plan and
    the tiling does not depend on ``elem``.

    The narrowest column tile that covers m (at most 256 columns), then the
    most rows per thread that still gives every SM two blocks, counting the
    tiles of every batch: 8 where K is megabytes (32 x 256 outputs, 32 KB, a
    block), 1 at the main path's small Grams, whose time is the launch's."""
    if chunked(d, elem):
        return fwd_dchunk_plan(n, m, d, sms, batch, elem)
    col_threads = next((c for c in FWD_COL_THREADS if FWD_COLS_PER_THREAD * c >= m),
                       FWD_COL_THREADS[-1])
    col_tile = FWD_COLS_PER_THREAD * col_threads
    row_groups = THREADS // col_threads
    col_tiles = -(-m // col_tile)
    for rt in FWD_ROWS_PER_THREAD:
        blocks = -(-n // (row_groups * rt)) * col_tiles * batch
        if blocks >= 2 * sms:
            break
    return FwdPlan(col_threads=col_threads, rows_per_thread=rt,
                   launches=int(n > 0 and m > 0 and batch > 0), batch=batch)


class BwdRowsPlan(NamedTuple):
    """How ``gram_bwd_rows`` cuts K: row tiles x column chunks, one block
    each. In a block, lanes_per_row lanes share a row and the 8 warps split
    the columns into ``slices``; a block walks its chunk in shared-memory
    stages of stage_cols columns."""

    lanes_per_row: int
    slices: int
    stage_cols: int
    chunk_cols: int  # columns of K per block, a multiple of stage_cols
    n_chunks: int
    row_tiles: int  # blocks along the rows: one ticket each (per batch) when n_chunks > 1
    # Per-chunk partials of one batch; None for one chunk.
    scratch_shape: Optional[Tuple[int, int, int]]
    launches: int  # kernel launches per call
    batch: int = 1  # Grams in the call: tickets and scratch are per batch

    entry, key = "gram_bwd_rows", "bwd_rows"
    workspace = property(lambda self: (self.row_tiles, self.scratch_shape))

    def args(self, ptrs, ws, n, m, d, size, strides, out_type):
        return (*ptrs, *ws, n, m, d, self.lanes_per_row, self.slices, self.stage_cols,
                self.chunk_cols, size, *strides)


def _round_up(v: int, k: int) -> int:
    return -(-v // k) * k


def bwd_rows_plan(n: int, m: int, d: int, sms: int, batch: int = 1,
                  elem: int = 4) -> BwdRowsPlan:
    """The tiling of ``gram_bwd_rows`` on a card with ``sms`` multiprocessors,
    for ``batch`` Grams of ``elem``-byte elements in one launch, whose row
    tiles count together when they fill the card (at B = 16 and 500 x 20: 8 columns a trip, 16 row
    tiles a batch, 256 blocks, one chunk; alone: 32 columns, 63 blocks).

    The columns a block takes per trip (lanes_per_row * slices, THREADS /
    rows a block) start at the power of two that covers m, at most
    ROWS_MAX_STEP, and are halved, down to ROWS_MIN_STEP, while the grid
    holds more threads than two blocks an SM (one at d > 16): 500 x 500 ->
    128 (16 lanes x 8 slices, 2 rows a block, 250 blocks); 9700 x 20 -> 4
    (64 rows a block, 152 blocks); 8192 x 8192 -> 8 (32 rows a block, so
    each staged xps row serves 32 rows). Slices take the step beyond 4 lanes,
    up to 8.

    A stage holds as many columns as fit in ROWS_STAGE_FLOATS, in multiples
    of 32. The columns are cut into chunks only where the row tiles leave
    SMs idle and each chunk keeps ROWS_CHUNK_MIN_COLS columns, since the
    chunks' sum (scratch, a ticket and a last block) costs about as much as
    a small call; so every call of the main path has one chunk, and one
    stage.

    In fp64 the stage holds ROWS_STAGE_FLOATS * 4 bytes too (half the
    columns), xps rows sit at an odd number of 16-byte pairs, and every
    build takes one block an SM. Past ``max_unchunked_d(elem)`` the
    d-chunked kernel runs, under :func:`dchunk_plan`'s tiling (a
    :class:`DchunkPlan`)."""
    if chunked(d, elem):
        return dchunk_plan(False, n, m, d, sms, batch, elem)
    resident = sms * THREADS * (2 if d <= 16 and elem == 4 else 1)
    step = min(ROWS_MAX_STEP, 1 << max(m - 1, 0).bit_length())
    while step > ROWS_MIN_STEP and batch * n * step > resident:
        step //= 2
    slices = min(THREADS // 32, max(1, step // 4))
    lanes = step // slices
    rows_tile = THREADS // step
    row_tiles = -(-n // rows_tile)
    # The kernel's stage: xps rows at an odd number of float4s, g rows padded
    # by `lanes` (csrc/gram.cu rows_smem).
    g_pad = lanes if lanes < 32 else 0
    vec = 16 // elem
    xps_pitch = ((d + vec - 1) // vec | 1) * vec
    stage = ROWS_STAGE_FLOATS * 4 // elem
    cap = max(32, (stage - rows_tile * g_pad) // (xps_pitch + rows_tile) // 32 * 32)
    n_chunks = 1
    if 0 < row_tiles * batch < sms:
        n_chunks = max(1, min(sms // (row_tiles * batch), m // ROWS_CHUNK_MIN_COLS))
    chunk_cols = -(-max(m, 1) // n_chunks)
    stage_cols = min(cap, _round_up(chunk_cols, 32))
    chunk_cols = _round_up(chunk_cols, stage_cols)
    n_chunks = -(-max(m, 1) // chunk_cols)
    return BwdRowsPlan(lanes_per_row=lanes, slices=slices, stage_cols=stage_cols,
                       chunk_cols=chunk_cols, n_chunks=n_chunks, row_tiles=row_tiles,
                       scratch_shape=(n_chunks, n, d + 1) if n_chunks > 1 else None,
                       launches=int(n > 0 and batch > 0), batch=batch)


class BwdColsPlan(NamedTuple):
    """How ``gram_bwd_cols`` splits K: column tiles x row chunks, one block each."""

    chunk_rows: int  # rows of K per block, a multiple of COLS_STAGE_ROWS
    n_chunks: int
    col_tiles: int  # one ticket each (per batch) when n_chunks > 1
    blocks: int
    # Per-chunk partials of one batch; None for one chunk.
    scratch_shape: Optional[Tuple[int, int, int]]
    launches: int  # kernel launches per call
    batch: int = 1  # Grams in the call: tickets and scratch are per batch

    entry, key = "gram_bwd_cols", "bwd_cols"
    workspace = property(lambda self: (self.col_tiles, self.scratch_shape))

    def args(self, ptrs, ws, n, m, d, size, strides, out_type):
        # The backward's arrays but the row sums, which this kernel does not take.
        return (*ptrs[:5], *ws, n, m, d, self.chunk_rows, size, *strides[:5])


def bwd_cols_plan(n: int, m: int, d: int, sms: int, batch: int = 1,
                  elem: int = 4) -> BwdColsPlan:
    """The chunking of ``gram_bwd_cols`` on a card with ``sms`` multiprocessors,
    for ``batch`` Grams of ``elem``-byte elements in one launch (their
    stage-tiles count together). The kernel's shared memory depends on d
    alone (two stages of 64 rows, at most 75 KB in fp64 at its DMAX of 32),
    so the chunks do not depend on ``elem``; past ``max_unchunked_d(elem)``
    the d-chunked kernel runs, under :func:`dchunk_plan`'s tiling.

    A block reduces whole stages of COLS_STAGE_ROWS rows. It takes one stage
    while the grid has fewer stage-tiles than twice ``sms`` (so a tall-skinny
    call fills the card: 9700 x 20 gives 152 blocks on 132 SMs), and more,
    double-buffered, when there is work for that many blocks several times
    over. The chunks are summed inside the same launch, so a call is always
    one launch."""
    if chunked(d, elem):
        return dchunk_plan(True, n, m, d, sms, batch, elem)
    col_tiles = -(-m // COLS_TILE)
    stages = max(1, -(-n // COLS_STAGE_ROWS))
    per_chunk = max(1, stages * col_tiles * batch // sms)
    n_chunks = -(-stages // per_chunk)
    return BwdColsPlan(
        chunk_rows=per_chunk * COLS_STAGE_ROWS,
        n_chunks=n_chunks,
        col_tiles=col_tiles,
        blocks=col_tiles * n_chunks * batch,
        scratch_shape=(n_chunks, m, d) if n_chunks > 1 else None,
        launches=int(m > 0 and batch > 0),
        batch=batch,
    )


# ---- the d-chunked backward (past max_unchunked_d) ----------------------------
#
# Constants of csrc/gram.cu's d-chunked kernels: a wide thread tile holds the
# distance of DC_OWN_ROWS owned x (16 / elem) walked pairs, a narrow one of
# one pair; TX walked and TY owned threads; the widest feature group of one
# W pass (bytes of a row); the most dynamic shared memory a block takes.
DC_OWN_ROWS = 4  # kDcRO
DC_MAX_TX, DC_MAX_TY = 64, 16  # kDcMaxTX, kDcMaxTY
DC_GROUP_BYTES = 8192  # kDcGroupBytes: W once per pair up to 2048 floats, 1024 doubles
DC_SMEM_MAX = 231424  # kDcSmemMax
SM_SMEM = 233472  # shared memory of an H100 SM (228 KB); a block reserves 1 KB of it
# The last block of an owned tile sums the chunks' partials: at most this many
# bytes a thread of it, where the card can be filled otherwise (a block reads
# ~128 bytes a thread per L2 round trip).
DC_SUM_BYTES_PER_THREAD = 1024


class DchunkPlan(NamedTuple):
    """How the d-chunked backward tiles K: owned tiles (rows of xs for the row
    kernel, of xps for the column kernel) x walked chunks x feature groups,
    one block each. Pass A's walk_threads x own_threads threads each take
    DC_OWN_ROWS owned x (16 / elem) walked pairs (``wide``) or one pair; a
    block walks its chunk in stages of ``stage`` rows."""

    wide: bool  # the thread tile
    walk_threads: int  # TX
    own_threads: int  # TY
    own_tile: int  # owned rows a block: TY (x DC_OWN_ROWS, wide)
    stage: int  # walked rows a stage: TX (x 16 / elem, wide)
    chunk: int  # walked rows a block: whole stages
    n_chunks: int
    groups: int  # feature groups: W is formed once per pair and group
    group_width: int  # features a group (the last may have fewer)
    tiles: int  # owned tiles
    tickets: int  # per batch: a tile's, and past 16 chunks its sum groups' too
    threads: int  # a block: TX * TY rounded up to whole warps, 256 for TX > 16
    smem_bytes: int
    blocks: int
    # Per-chunk partials of one batch (n_chunks + the sum groups' past 16
    # chunks, owned, d + 1 or d); None for one chunk.
    scratch_shape: Optional[Tuple[int, int, int]]
    launches: int  # kernel launches per call
    batch: int = 1  # Grams in the call: tickets and scratch are per batch
    cols: bool = False  # the column half (owned rows of xps); its launches count as bwd_cols

    entry = "gram_bwd_dchunk"
    key = property(lambda self: "bwd_cols" if self.cols else "bwd_rows")
    workspace = property(lambda self: (self.tickets, self.scratch_shape))

    def args(self, ptrs, ws, n, m, d, size, strides, out_type):
        return (int(self.cols), int(self.wide), *ptrs, *ws, n, m, d, self.walk_threads,
                self.own_threads, self.chunk, self.groups, self.group_width, self.threads,
                size, *strides)


def dchunk_sum_groups(n_chunks: int) -> int:
    """The groups a tile's chunk partials are summed in (csrc/gram.cu
    dc_sum_groups): one up to 16 chunks, else ceil(sqrt(n_chunks)), each
    summed by its own last block before the last of those sums the groups."""
    return 1 if n_chunks <= 16 else math.isqrt(n_chunks - 1) + 1


def dchunk_chunks(width: int, merge: bool, elem: int = 4) -> int:
    """The 256-byte d-chunks of ``width`` features (csrc/gram.cu dc_chunks):
    with ``merge`` a remainder of up to 16 bytes past two chunks or more
    rides with the last full chunk."""
    dc, v = 256 // elem, 16 // elem
    if merge and width > 2 * dc and (width - 1) % dc < v:
        return width // dc
    return -(-width // dc)


def dchunk_merges(own_tile: int, wide: bool, threads: int, elem: int = 4) -> bool:
    """Whether a block merges a short last chunk: where a merged chunk's
    17 16-byte vectors of pass-B items, per owned-row group, fit its threads
    in one round."""
    return own_tile // (DC_OWN_ROWS if wide else 1) * (256 // elem // (16 // elem) + 1) <= threads


def dchunk_smem(cols: bool, own_tile: int, stage: int, group_width: int, elem: int = 4) -> int:
    """Bytes of dynamic shared memory of a d-chunked block (csrc/gram.cu
    dc_smem): the owned tile's accumulators and row sums, the g tile and in
    its place the W tile, and the owned and walked rows of a chunk as the
    passes read them (a pitch of 17 16-byte units) and as copied (18)."""
    v = 16 // elem
    pitch = 256 // elem + v
    acc = own_tile * _round_up(group_width, v)
    w = stage * (own_tile + v)
    g = stage * (own_tile + v) if cols else own_tile * (stage + v)
    return elem * (acc + _round_up(own_tile, v) + _round_up(max(w, g), v)
                   + (own_tile + stage) * (2 * pitch + v))


def _dchunk_resident(smem: int, threads: int, elem: int) -> int:
    """Blocks of a d-chunked plan an SM holds: by shared memory (1 KB a block
    reserved), by registers (at most 128 a thread in fp32, 255 in fp64), by
    threads (2048)."""
    regs = 128 if elem == 4 else 255
    return max(1, min(SM_SMEM // (smem + 1024), 65536 // (threads * regs), 2048 // threads))


def _dchunk_shapes(own: int, walk: int, v: int):
    """Pass A's (wide, TX, TY) candidates. Wide: TX covers the walked side in
    16-byte rows up to 16, TY the owned side up to 16 (also TY that fill
    whole warps beside TX), and, for at most 32 owned rows and a long walked
    side, TX = 32 or 64 at TY <= 2 (a tall-skinny column call, whose last
    block then sums small partials). Narrow, one pair a thread: TX covers
    the walked side up to 16, TY the owned side up to 16. Those that fill at
    least 2/3 of their warps, if any."""
    tx0 = min(16, max(1, -(-walk // v)))
    ty_cap = min(DC_MAX_TY, max(1, -(-own // DC_OWN_ROWS)))
    tys = {ty_cap, 16, 12, 8, 6, 4, 2, 1} | {32 * k // tx0 for k in range(1, 9)}
    shapes = [(True, tx0, ty) for ty in sorted(tys, reverse=True) if 1 <= ty <= ty_cap]
    if ty_cap <= 8:  # few owned rows: wider stages beside the narrowest tiles
        shapes += [(True, tx, ty) for tx in (32, 64) if tx0 == 16 and walk > tx // 2 * v
                   for ty in (2, 1) if ty <= ty_cap]
    tx1 = min(16, max(1, walk))
    shapes += [(False, tx1, ty) for ty in (16, 12, 8, 6, 4, 2) if ty <= own + 1]
    full = [s for s in shapes if 3 * s[1] * s[2] >= 2 * _round_up(s[1] * s[2], 32)]
    return full or shapes


def dchunk_candidates(cols: bool, n: int, m: int, d: int, sms: int, batch: int = 1,
                      elem: int = 4):
    """[(estimated cycles, DchunkPlan)] for each shape of
    :func:`_dchunk_shapes` whose shared memory fits, at K of n x m on d
    features, ``batch`` Grams of ``elem``-byte elements, ``sms``
    multiprocessors (the column kernel when ``cols``).

    Features: one group (W once per pair) up to DC_GROUP_BYTES of a row,
    else groups of whole 256-byte chunks. The walked side is cut into chunks
    of whole stages only where the owned tiles (times groups and batch)
    leave SMs idle, as many as give every SM a block, up to as many as the
    blocks resident on it (:func:`_dchunk_resident`) and the last block's
    sum (DC_SUM_BYTES_PER_THREAD a thread) allow.

    The estimate, in cycles, per stage of a wave of blocks: the longest of a
    thread's chain of instructions (~d (4 q + 2 (RO + RA) / v) for q = RO x
    RA pairs, and its share of the staging, ~16 an 16-byte copy or repack;
    ~8 / q cycles an instruction where q < 8, and 4 / w where a wide tile
    leaves its SM's schedulers w < 1 warp each: a lone warp issues its chain
    at the latency; without that term the plan took the wide tile at the
    rows of 9700 x 20 x 385 and at fp64 20 x 20 x 90, 203 and 27 us, where
    one pair a thread took 173 and 20, NVIDIA H100 80GB HBM3), the SM's issue of
    every resident warp's, the SM's shared-memory reads (128 bytes a cycle;
    a thread reads its RO + RA rows' 16 bytes per 16 bytes of features, in
    both passes), the SM's copies from L2 (~32 bytes a cycle: the
    stage's rows twice and its g tile) and the steps' copy round trips and
    barriers (~1,500 cycles a 256-byte chunk); plus the last block's sum,
    ~128 bytes a thread per L2 round trip of ~800 cycles."""
    own, walk = (m, n) if cols else (n, m)
    v, dc = 16 // elem, 256 // elem
    groups = -(-d * elem // DC_GROUP_BYTES)
    gw = d if groups == 1 else _round_up(-(-d // groups), dc)
    groups = -(-d // gw)
    width = d if cols else d + 1
    out = []
    for wide, tx, ty in _dchunk_shapes(own, walk, v):
        ro, ra = (DC_OWN_ROWS, v) if wide else (1, 1)
        to, ta = ro * ty, ra * tx
        smem = dchunk_smem(cols, to, ta, gw, elem)
        if smem > DC_SMEM_MAX:
            continue
        warps = -(-tx * ty // 32)  # pass A's and pass B's
        # A tall-skinny column plan (TX > 16) sums many chunks' partials in
        # each tile's last block: a whole block of threads for that.
        threads = THREADS if tx > 16 else 32 * warps
        merge = dchunk_merges(to, wide, threads, elem)
        steps = dchunk_chunks(d, merge, elem) + dchunk_chunks(gw, merge, elem)
        resident = _dchunk_resident(smem, threads, elem)
        tiles = -(-own // to)
        stages = -(-walk // ta)
        per = tiles * groups * batch
        spc = max(stages, 1)
        if stages > 1 and 0 < per < sms:
            lo = -(-sms // per)
            cap = max(1, threads * DC_SUM_BYTES_PER_THREAD // (to * width * elem))
            target = min(stages, max(lo, resident * sms // per), max(lo, cap))
            spc = max(1, stages // target)
        n_chunks = max(1, -(-stages // spc))
        blocks = tiles * n_chunks * groups * batch
        waves = -(-blocks // (resident * sms))
        on_sm = min(resident, -(-blocks // sms))
        q = ro * ra
        # A thread's instructions a stage: the pairs' and, per 256-byte
        # step, its share of the rows' 16-byte copies and repacks (~16 each).
        chain = (d * (4 * q + 2 * (ro + ra) / v)
                 + steps * (to + ta) * 2 * (dc // v + 1) * 16 / threads)
        lds = 2 * d / v * (ro + ra) * 16  # shared bytes a thread reads a stage, both passes
        # Schedulers left with under a warp each (on_sm * warps < 4) issue a
        # thread's chain at its latency, ~4 cycles an instruction.
        per_sched = on_sm * warps / 4
        lone = 4 / per_sched if q > 1 and 0 < per_sched < 1 else 1.0
        stage_cycles = max(chain * max(1.0, 8 / q, lone),
                           on_sm * warps * chain / 4,
                           on_sm * warps * 32 * lds / 128,
                           on_sm * elem * (2 * (to + ta) * d + to * ta) / 32, steps * 1500)
        n_sum = dchunk_sum_groups(n_chunks)
        per = -(-n_chunks // n_sum)  # the last blocks sum a group's chunks, then the groups
        levels = per + (-(-n_chunks // per) if n_sum > 1 else 0)
        sums = 0 if n_chunks == 1 else -(-levels * to * width * elem // threads)
        est = waves * min(spc, max(stages, 1)) * stage_cycles + 800 * -(-sums // 128)
        out.append((est, DchunkPlan(
            wide=wide, walk_threads=tx, own_threads=ty, own_tile=to, stage=ta, chunk=spc * ta,
            n_chunks=n_chunks, groups=groups, group_width=gw, tiles=tiles,
            tickets=tiles * (1 + (n_sum if n_sum > 1 else 0)), threads=threads,
            smem_bytes=smem, blocks=blocks,
            scratch_shape=((n_chunks + (n_sum if n_sum > 1 else 0), own, width)
                           if n_chunks > 1 else None),
            launches=int(own > 0 and batch > 0), batch=batch, cols=cols)))
    return out


def dchunk_plan(cols: bool, n: int, m: int, d: int, sms: int, batch: int = 1,
                elem: int = 4, wide: Optional[bool] = None) -> DchunkPlan:
    """The tiling of the d-chunked backward (the column kernel when ``cols``)
    at K of n x m on d features, for ``batch`` Grams of ``elem``-byte
    elements on a card with ``sms`` multiprocessors: among the candidates
    (:func:`dchunk_candidates`) whose grid gives nine SMs in ten a block (all,
    if none does; at 500 x 500 x 65, 128 blocks of 128 threads took 37 us
    where 256 of 64 took 43, on an H100) and whose estimate is within 5% of
    the least, the one of most
    pairs a block-stage (the larger tile amortizes a step's copies and
    barriers, which the estimate does not see), then the most blocks.
    ``wide``: only that thread tile (bench_gram --tiles times the other)."""
    cands = [c for c in dchunk_candidates(cols, n, m, d, sms, batch, elem)
             if wide is None or c[1].wide == wide]
    if not cands:
        raise ValueError(f"no d-chunked tiling fits {n} x {m} x {d} ({elem}-byte elements)")
    pool = [c for c in cands if 10 * c[1].blocks >= 9 * sms] or cands
    best = min(est for est, _ in pool)
    near = [p for est, p in pool if est <= 1.05 * best]  # within the estimate's noise
    return max(near, key=lambda p: (p.own_tile * p.stage, p.blocks, p.own_threads))


# ---- the d-chunked forward (past max_unchunked_d) -----------------------------
#
# Constants of csrc/gram.cu's gram_fwd_kernel_dchunk: its thread tiles (rows x
# columns a thread, kFdRows / kFdCols, by index), and the shared memory a
# block may take where two blocks share an SM.
FD_TILES = ((1, 1), (1, 4), (8, 8), (4, 4))
FD_TWO_A_SM = SM_SMEM // 2 - 1024  # 115,712 bytes
# Registers a thread may take, per tile: __launch_bounds__(256, blocks) of
# 4 / 4 / 2 / 2 blocks in fp32, 2 / 2 / 1 / 1 in fp64.
_FD_REGS = {4: (64, 64, 128, 128), 8: (128, 128, 255, 255)}


class FwdDchunkPlan(NamedTuple):
    """How the d-chunked forward tiles K: row tiles x column tiles, one
    block each, of row_threads x col_threads threads that each take
    rows_per_thread x cols_per_thread pairs; a block stages ``stage``
    features of its rows at a time, ``stages`` stages."""

    tile: int  # index into FD_TILES
    rows_per_thread: int
    cols_per_thread: int
    col_threads: int  # TX
    row_threads: int  # TY
    row_tile: int  # rows a block: rows_per_thread x TY
    col_tile: int  # columns a block: cols_per_thread x TX
    threads: int  # a block: TX x TY rounded up to whole warps
    stage: int  # features a stage (kc)
    stages: int
    smem_bytes: int
    blocks: int
    launches: int  # kernel launches per call
    batch: int = 1

    entry, key, workspace = "gram_fwd_dchunk", "fwd_dchunk", None

    def args(self, ptrs, ws, n, m, d, size, strides, out_type):
        return (*ptrs, n, m, d, self.tile, self.col_threads, self.row_threads, self.threads,
                self.stage, out_type, size, *strides)


def fwd_dchunk_smem(row_tile: int, col_tile: int, kc: int, d: int, elem: int = 4,
                    xs_raw: bool = False) -> int:
    """Bytes of dynamic shared memory of a d-chunked forward block
    (csrc/gram.cu fd_smem): up to three raw stages of the tile's rows as
    copied (16-byte blocks, at a pitch 32 bytes past a multiple of 64; the
    row counts rounded up to 4) and up to two transposed stages ([kc][rows],
    [kc][columns], at pitches 16 bytes past a multiple of 128). ``xs_raw``
    (a tile of one row a thread, which sums xs from the raw stage): up to
    four raw stages, and no xs rows transposed."""
    v = 16 // elem

    def pitch(p, mod, rem):
        while p * elem % mod != rem:
            p += v
        return p

    stages = -(-d // kc)
    rt4, ct4 = _round_up(row_tile, 4), _round_up(col_tile, 4)
    pr = pitch((kc + 2 * v - 2) // v * v, 64, 32)
    ps, px = pitch(rt4, 128, 16), pitch(ct4, 128, 16)
    return elem * (min(stages, 4 if xs_raw else 3) * (rt4 + ct4) * pr
                   + min(stages, 2) * kc * ((0 if xs_raw else ps) + px))


def _fd_shapes(n: int, m: int, tile: int):
    """(TX, TY) candidates of thread tile ``tile``: TX the column threads
    that cover m, or 4 to 64 of them (at most 256 columns a block); TY the
    row threads that fill 256, 128, 64 or 32 threads with them, at most those
    that cover n; those that fill at least 2/3 of their warps, if any."""
    rt, ct = FD_TILES[tile]
    cover = max(1, -(-m // ct))
    txs = {min(c, cover) for c in (4, 8, 16, 32, 64)} | ({cover} if cover <= 64 else set())
    shapes = sorted({(tx, max(1, min(block // tx, -(-n // rt))))
                     for tx in txs if ct * tx <= 256 for block in (256, 128, 64, 32)})
    full = [(tx, ty) for tx, ty in shapes if 3 * tx * ty >= 2 * _round_up(tx * ty, 32)]
    return full or shapes


def fwd_dchunk_candidates(n: int, m: int, d: int, sms: int, batch: int = 1, elem: int = 4):
    """[(estimated cycles, FwdDchunkPlan)] for every thread tile and (TX,
    TY) of :func:`_fd_shapes` at K of n x m on d features, ``batch`` Grams
    of ``elem``-byte elements, on ``sms`` multiprocessors.

    The stage: all of d where the tile's rows fit the shared memory a block
    may take (FD_TWO_A_SM where its registers leave two blocks an SM, else
    DC_SMEM_MAX), else the fewest stages that fit, of equal widths.

    The estimate, in cycles, per wave of blocks: the longest of a
    scheduler's issue of its warps' instructions (a thread's: 2 q
    instructions a feature for q pairs, twice that in fp64, whose pipe
    issues at half the rate, its shared loads, ~4 an element of its share
    of the copies and transposes, ~16 a pair of the epilogue), a thread's
    chain (a feature at least 4 cycles, an FMA's latency) and the SM's
    copies from L2 (~32 bytes a cycle); plus ~600 cycles a stage (its
    barrier and transpose) and ~1,500 for the first copies' round trip."""
    v = 16 // elem
    fp = 2 if elem == 8 else 1
    out = []
    for tile, (rt, ct) in enumerate(FD_TILES):
        for tx, ty in _fd_shapes(n, m, tile):
            threads = _round_up(tx * ty, 32)
            regs = _FD_REGS[elem][tile]
            by_regs = 65536 // (threads * regs)
            if by_regs < 1:
                continue
            budget = FD_TWO_A_SM if by_regs >= 2 else DC_SMEM_MAX
            rows, cols = rt * ty, ct * tx
            for stages in range(1, d + 1):
                kc = -(-d // stages)
                smem = fwd_dchunk_smem(rows, cols, kc, d, elem, rt == 1)
                if smem <= budget:
                    break
            if smem > budget or kc < 8 or -(-m // cols) > 65535:
                continue
            stages = -(-d // kc)
            resident = max(1, min(SM_SMEM // (smem + 1024), by_regs, 2048 // threads, 32))
            blocks = -(-n // rows) * -(-m // cols) * batch
            waves = -(-blocks // (resident * sms))
            on_sm = min(resident, -(-blocks // sms))
            q = rt * ct
            loads = ((rt // 4) * (elem // 4) if rt >= 4 else 1) + ((ct // 4) * (elem // 4)
                                                                   if ct >= 4 else 1)
            staging = (rows + cols) * d * 4 / threads
            instr = d * (2 * q * fp + loads) + staging + 16 * q
            issue = on_sm * threads / 32 / 4 * instr
            chain = d * max(4 * fp, 2 * q * fp + loads) + staging + 16 * q
            copy = on_sm * (rows + cols) * d * elem / 32
            est = waves * (max(issue, chain, copy) + 600 * stages + 1500)
            out.append((est, FwdDchunkPlan(
                tile=tile, rows_per_thread=rt, cols_per_thread=ct, col_threads=tx,
                row_threads=ty, row_tile=rows, col_tile=cols, threads=threads, stage=kc,
                stages=stages, smem_bytes=smem, blocks=blocks,
                launches=int(n > 0 and m > 0 and batch > 0), batch=batch)))
    return out


def fwd_dchunk_plan(n: int, m: int, d: int, sms: int, batch: int = 1, elem: int = 4,
                    tile: Optional[int] = None) -> FwdDchunkPlan:
    """The tiling of the d-chunked forward at K of n x m on d features, for
    ``batch`` Grams of ``elem``-byte elements on a card with ``sms``
    multiprocessors: among the candidates (:func:`fwd_dchunk_candidates`)
    whose grid gives nine SMs in ten a block (all, if none does), the least
    estimate; within 2% of it, the tile that stages the fewest bytes a pair
    (the squarest), then the most blocks. ``tile``: only that thread tile
    (bench_gram --tiles times the others)."""
    cands = [c for c in fwd_dchunk_candidates(n, m, d, sms, batch, elem)
             if tile is None or c[1].tile == tile]
    if not cands:
        raise ValueError(f"no d-chunked forward tiling fits {n} x {m} x {d} "
                         f"({elem}-byte elements)")
    pool = [c for c in cands if 10 * c[1].blocks >= 9 * sms] or cands
    best = min(est for est, _ in pool)
    near = [p for est, p in pool if est <= 1.02 * best]
    return min(near, key=lambda p: ((p.row_tile + p.col_tile) / (p.row_tile * p.col_tile),
                                    -p.blocks, p.tile, p.col_threads))


# ---- plain versions (CPU path, and the kernels' oracle on the card) ---------


def _plain_sig(xs, xps, sig):
    """sig as it broadcasts against K: as given unbatched, [B, 1, 1] (or
    [1, 1, 1], shared) when xs or xps carries a batch axis."""
    return sig.reshape(-1, 1, 1) if xs.dim() > 2 or xps.dim() > 2 else sig


def gram_fwd_plain(xs, xps, sig, out_dtype=None, diag_add=None):
    """sig * exp(0.5 (2 xs.xps^T - |xs|^2 - |xps|^2)): the cross-term form of
    the JAX ``ard_gram`` on pre-scaled inputs; with ``diag_add`` that scalar
    added where i == j, then rounded once to ``out_dtype`` (None: the
    inputs' dtype). Batched as the kernels are (module docstring)."""
    neg_d2 = (
        2.0 * torch.matmul(xs, xps.mT)
        - torch.sum(xs * xs, dim=-1, keepdim=True)
        - torch.sum(xps * xps, dim=-1, keepdim=True).mT
    )
    K = _plain_sig(xs, xps, sig) * torch.exp(0.5 * neg_d2)
    if diag_add is not None:
        K.diagonal(dim1=-2, dim2=-1).add_(diag_add)
    return K if out_dtype is None else K.to(out_dtype)


def gram_bwd_rows_plain(xs, xps, sig, g):
    """(d_xs, rowsum): d_xs = W xps - rowsum(W) xs, W = g * K
    (`gram_pallas.py:116-125`)."""
    W = g * gram_fwd_plain(xs, xps, sig)
    row = torch.sum(W, dim=-1)
    return torch.matmul(W, xps) - row[..., None] * xs, row


def gram_bwd_cols_plain(xs, xps, sig, g):
    """d_xps = W^T xs - colsum(W) xps, W = g * K (`gram_pallas.py:124-126`)."""
    W = g * gram_fwd_plain(xs, xps, sig)
    col = torch.sum(W, dim=-2)
    return torch.matmul(W.mT, xs) - col[..., None] * xps


def gram_bwd_plain(xs, xps, sig, g):
    """(d_xs, d_xps, rowsum) of the backward, plain."""
    d_xs, row = gram_bwd_rows_plain(xs, xps, sig, g)
    return d_xs, gram_bwd_cols_plain(xs, xps, sig, g), row


# ---- kernel wrappers ---------------------------------------------------------


def _check(xs, xps, sig, g=None) -> Optional[int]:
    """Raise on what the kernels do not take: float32 or float64, every input
    of xs's dtype, row-major contiguous, [n, d] / [m, d] with d >= 1, one sig
    value, g [n, m], or the
    same with a leading batch axis on any of xs, xps and g ([B, n, d],
    [B, m, d], [B, n, m]; B the same on all that have it) and sig one value
    or B. Returns B, or None for an unbatched call."""
    tensors = [xs, xps, sig] + ([] if g is None else [g])
    if xs.dtype not in DTYPES:
        raise TypeError(f"gram kernel takes float32 or float64, got {xs.dtype}")
    for t in tensors:
        if t.dtype != xs.dtype:
            raise TypeError(f"gram kernel inputs of {t.dtype} and {xs.dtype}")
        if not t.is_contiguous():
            raise ValueError("gram kernel takes contiguous tensors")
        if t.device != xs.device:
            raise ValueError(f"gram kernel inputs on {t.device} and {xs.device}")
    mats = [xs, xps] + ([] if g is None else [g])
    if any(t.dim() not in (2, 3) for t in mats) or xs.shape[-1] != xps.shape[-1]:
        raise ValueError(f"gram kernel takes [n, d] and [m, d], each with or without a "
                         f"leading batch axis, got {tuple(xs.shape)}, {tuple(xps.shape)}")
    batches = {t.shape[0] for t in mats if t.dim() == 3}
    if len(batches) > 1:
        raise ValueError(f"gram kernel inputs of batches {sorted(batches)}")
    batch = batches.pop() if batches else None
    if xs.shape[-1] < 1:
        raise ValueError("gram kernel takes d >= 1, got d = 0")
    if sig.numel() != 1 and (batch is None or sig.numel() != batch):
        raise ValueError(f"sig must hold one value{'' if batch is None else ' or ' + str(batch)}"
                         f", got shape {tuple(sig.shape)}")
    if g is not None and tuple(g.shape[-2:]) != (xs.shape[-2], xps.shape[-2]):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != "
                         f"{(xs.shape[-2], xps.shape[-2])}")
    return batch


def _bstride(t, batch) -> int:
    """``t``'s batch stride in elements: 0 where every batch shares it."""
    if t.dim() == 3:
        return t.stride(0)
    return 1 if t.dim() == 1 and batch is not None and t.numel() == batch > 1 else 0


def _require_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"gram kernel takes CUDA tensors, got {t.device}")


@functools.lru_cache(maxsize=1024)
def _device_plans(device, n, m, d, batch, elem, plan):
    """``plan`` (:func:`fwd_plan`, :func:`bwd_rows_plan`, :func:`bwd_cols_plan`)
    of each chunk of :func:`_build.batch_chunks` (``batch``) for the card
    ``device``, looked up once per shape, batch and element size."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return tuple(plan(n, m, d, sms, size, elem=elem) for _, size in _build.batch_chunks(batch))


# The backward kernels' workspace by (device, stream, dtype), shared by both: the
# tickets (one int per (batch, tile), 0 between launches, since a kernel's
# last block of a tile sets its ticket back) and the scratch of per-chunk
# partials of every batch.
# Launches that share them must run in order, which one stream guarantees.
# Both only grow, by being replaced; a CUDA graph keeps the addresses it
# captured, so a capture must find its stream's workspace large enough (an
# eager call of the same shapes on that stream first sizes it): growing
# during a capture raises. The tickets' invariant holds across replays as
# across launches.
_WORKSPACES = {}


def _workspace(device, stream, tiles, scratch_shape, batch=1, dtype=torch.float32):
    tiles *= batch
    floats = 0 if scratch_shape is None else batch * math.prod(scratch_shape)
    ws = _WORKSPACES.get((device, stream, dtype))
    if ws is None or ws[0].numel() < tiles or ws[1].numel() < floats:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the Gram backward's workspace would grow during a CUDA graph capture "
                f"(to {tiles} tickets, {floats} scratch floats): run the step once on the "
                "capture stream before capturing it")
        tiles = max(tiles, 1 if ws is None else ws[0].numel())
        floats = max(floats, 1 if ws is None else ws[1].numel())
        ws = (torch.zeros(tiles, dtype=torch.int32, device=device),
              torch.empty(floats, dtype=dtype, device=device))
        _WORKSPACES[(device, stream, dtype)] = ws
    return ws


# gram_fwd's output types, as csrc/gram.cu numbers them.
OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _launch_plan(lib, stream, plans, arrays, strides, n, m, d, out_type=0):
    """Launch ``plans`` (one for each chunk of :func:`_build.batch_chunks` of
    their Grams; ``[plan]`` to force one) on ``stream`` through
    :func:`_build.launch`. ``arrays``: the entry's, each a tensor at the next
    of ``strides`` (its batch stride, which the entry also takes), a raw
    pointer or None. Sizes a backward plan's workspace for every chunk first;
    counts the launches under the plan's ``LAUNCHES`` key."""
    first = plans[0]
    if not first.launches:  # an empty K, or no rows or no columns
        return
    x = arrays[0]
    ws = ()
    for plan in plans:  # one workspace, sized for the largest chunk
        if plan.workspace is not None:
            ticket, scratch = _workspace(x.device, stream, *plan.workspace, plan.batch, x.dtype)
            ws = (scratch.data_ptr(), ticket.data_ptr())
    it = iter(strides)
    ptrs = [_build.Batched(a, next(it)) if isinstance(a, torch.Tensor) else a for a in arrays]
    by_size = {plan.batch: plan for plan in plans}
    LAUNCHES[first.key] += _build.launch(
        _build.entry(lib, first.entry, x.dtype), sum(plan.batch for plan in plans),
        lambda size: by_size[size].args(ptrs, ws, n, m, d, size, strides, out_type), stream)


def gram_fwd_cuda(xs, xps, sig, out_dtype=None, diag_add=None):
    """K [n, m] (or [B, n, m]) from the forward kernel, one launch a chunk
    of :func:`_build.batch_chunks`, tiled by :func:`fwd_plan` (past
    max_unchunked_d the d-chunked kernel, :func:`fwd_dchunk_plan`), in
    ``out_dtype`` (None: the inputs' dtype; from float32 inputs also bfloat16
    or float16, from float64 ones float64 only), with the scalar tensor
    ``diag_add`` added where i == j before the one rounding: inside the
    kernel for a 2-byte K, by one add after it for an fp32 or fp64 K (those
    kernels carry no diagonal code)."""
    _require_cuda(xs)
    batch = _check(xs, xps, sig)
    out_dtype = xs.dtype if out_dtype is None else out_dtype
    allowed = OUT_TYPES if xs.dtype == torch.float32 else {torch.float64: 0}
    if out_dtype not in allowed:
        raise TypeError(f"gram_fwd writes {sorted(map(str, allowed))} from {xs.dtype}, "
                        f"not {out_dtype}")
    if diag_add is not None and diag_add.numel() != 1:
        raise ValueError(f"diag_add must hold one value, got shape {tuple(diag_add.shape)}")
    if diag_add is not None:
        _check(xs, xps, diag_add)
    n, d = xs.shape[-2:]
    m = xps.shape[-2]
    out = torch.empty((n, m) if batch is None else (batch, n, m), dtype=out_dtype, device=xs.device)
    in_kernel = diag_add is not None and out_dtype not in DTYPES
    diag = diag_add.data_ptr() if in_kernel else None
    bs = [_bstride(t, batch) for t in (xs, xps, sig, out)]
    with torch.cuda.device(xs.device):
        _launch_plan(_build.load_library(), torch.cuda.current_stream().cuda_stream,
                     _device_plans(xs.device, n, m, d, batch or 1, xs.element_size(), fwd_plan),
                     (xs, xps, sig, diag, out), bs, n, m, d, allowed[out_dtype])
    if diag_add is not None and not in_kernel:
        out.diagonal(dim1=-2, dim2=-1).add_(diag_add)
    return out


def _gram_bwd(xs, xps, sig, g, rows=True, cols=True):
    """(d_xs, d_xps, rowsum) from the row kernel (without ``rows`` None, None)
    and the column kernel (without ``cols`` None), after one check, library
    load and stream lookup: tiled by :func:`bwd_rows_plan` and
    :func:`bwd_cols_plan`; [B, n, d], [B, m, d] and [B, n] batched."""
    _require_cuda(xs)
    batch = _check(xs, xps, sig, g)
    lib = _build.load_library()
    n, d = xs.shape[-2:]
    m = xps.shape[-2]
    lead = () if batch is None else (batch,)
    new = functools.partial(torch.empty, dtype=xs.dtype, device=xs.device)
    shared = [_bstride(t, batch) for t in (xs, xps, sig, g)]
    plans = functools.partial(_device_plans, xs.device, n, m, d, batch or 1, xs.element_size())
    d_xs = row = d_xps = None
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rows:
            d_xs, row = new((*lead, n, d)), new((*lead, n))
            _launch_plan(lib, stream, plans(bwd_rows_plan), (xs, xps, sig, g, d_xs, row),
                         shared + [_bstride(d_xs, batch), 0 if batch is None else n], n, m, d)
        if cols:
            d_xps = new((*lead, m, d))
            _launch_plan(lib, stream, plans(bwd_cols_plan), (xs, xps, sig, g, d_xps, None),
                         shared + [_bstride(d_xps, batch), 0], n, m, d)
    return d_xs, d_xps, row


def gram_bwd_rows_cuda(xs, xps, sig, g):
    """(d_xs, rowsum) from the row kernel of the backward (:func:`_gram_bwd`)."""
    return _gram_bwd(xs, xps, sig, g, cols=False)[::2]


def gram_bwd_cols_cuda(xs, xps, sig, g):
    """d_xps from the column kernel of the backward (:func:`_gram_bwd`)."""
    return _gram_bwd(xs, xps, sig, g, rows=False)[1]


def gram_bwd_cuda(xs, xps, sig, g):
    """(d_xs, d_xps, rowsum) from the two backward kernels (:func:`_gram_bwd`)."""
    return _gram_bwd(xs, xps, sig, g)


def _span(name, xs, xps, g=None):
    """The span of one dispatcher call. Attributes: ``kernel``, the
    ``LAUNCHES`` keys the call adds on a card ("fwd" or "fwd_dchunk"; the
    backward ("bwd_rows", "bwd_cols")); the shape ``n``, ``m``, ``d`` and
    ``batch`` (None unbatched); ``chunked``, :func:`chunked`."""
    n, d = xs.shape[-2:]
    is_chunked = chunked(d, xs.element_size())
    if g is None:
        kernel = "fwd_dchunk" if is_chunked else "fwd"
    else:
        kernel = ("bwd_rows", "bwd_cols")
    batch = next((t.shape[0] for t in (xs, xps, g) if t is not None and t.dim() == 3), None)
    return profiling.span(name, xs.device, kernel=kernel, n=n, m=xps.shape[-2], d=d,
                          batch=batch, chunked=is_chunked)


def gram_fwd(xs, xps, sig, out_dtype=None, diag_add=None):
    """K of pre-scaled inputs (in ``out_dtype``, with ``diag_add`` on the
    diagonal): the kernel on CUDA, the plain version on CPU."""
    with _span("gram.fwd", xs, xps):
        if xs.device.type == "cpu":
            return gram_fwd_plain(xs, xps, sig, out_dtype, diag_add)
        return gram_fwd_cuda(xs, xps, sig, out_dtype, diag_add)


def gram_bwd(xs, xps, sig, g):
    """(d_xs, d_xps, rowsum): the kernels on CUDA, the plain version on CPU."""
    with _span("gram.bwd", xs, xps, g):
        if xs.device.type == "cpu":
            return gram_bwd_plain(xs, xps, sig, g)
        return gram_bwd_cuda(xs, xps, sig, g)


def _inv_len(log_length):
    """1 / l as it broadcasts against x [..., n, d]: a [d] (or one shared)
    length as a row [1, d], a batch of them [B, d] (or [B, 1]) as [B, 1, d]."""
    inv = torch.exp(-log_length)
    return inv.reshape(1, -1) if log_length.dim() <= 1 else inv.unsqueeze(-2)


def scale_inputs(x, log_length):
    """x / l, row-major: the inputs the kernels take. A batch of lengths
    [B, d] scales a shared x [n, d] into [B, n, d]."""
    return (x * _inv_len(log_length)).contiguous()


def _scale_inputs(x, xp, log_signal_sq, log_length):
    return scale_inputs(x, log_length), scale_inputs(xp, log_length), torch.exp(log_signal_sq)


class ArdGram(torch.autograd.Function):
    """ARD Gram K(x, xp) with the kernel backward (`gram_pallas.py:96-136`).

    Batched leaves: log_signal_sq [B] and log_length [B, d] (or [B, 1], one
    length per batch) give K [B, n, m], each batch's from its own leaves;
    x and xp are [B, ., d], or [., d] shared by every batch. Where an input
    was shared, its gradient is summed over the batch, and only when asked
    for."""

    @staticmethod
    def forward(ctx, x, xp, log_signal_sq, log_length):
        xs, xps, sig = _scale_inputs(x, xp, log_signal_sq, log_length)
        # Only the O(nd) scaled inputs are saved; the backward recomputes K.
        ctx.save_for_backward(xs, xps, sig, log_length)
        ctx.shapes = (x.shape, xp.shape)
        return gram_fwd(xs, xps, sig)

    @staticmethod
    def backward(ctx, g):
        xs, xps, sig, log_length = ctx.saved_tensors
        # The cotangent often arrives transposed (V = tri_solve(L, K_fu^T)^T
        # in the FITC terms); the kernels take it row-major.
        d_xs, d_xps, row = gram_bwd(xs, xps, sig, g.contiguous())
        inv_len = _inv_len(log_length)
        if g.dim() == 2:  # unbatched
            d_log_sig = torch.sum(row).reshape(sig.shape)
            d_log_len = -(torch.sum(d_xs * xs, dim=0) + torch.sum(d_xps * xps, dim=0))
            if log_length.numel() != d_log_len.numel():  # one length shared by all dims
                d_log_len = d_log_len.sum()
            return (d_xs * inv_len, d_xps * inv_len, d_log_sig,
                    d_log_len.reshape(log_length.shape))
        # Batched: every gradient is [B, ...]; a leaf that every batch shared
        # takes the sum over the batch.
        x_shape, xp_shape = ctx.shapes
        need = ctx.needs_input_grad
        d_log_sig = torch.sum(row, dim=-1).sum_to_size(sig.shape) if need[2] else None
        d_log_len = None
        if need[3]:
            d_log_len = -(torch.sum(d_xs * xs, dim=-2) + torch.sum(d_xps * xps, dim=-2))
            d_log_len = d_log_len.sum_to_size(
                log_length.shape if log_length.dim() > 1 else (log_length.numel(),))
            d_log_len = d_log_len.reshape(log_length.shape)
        d_x = (d_xs * inv_len).sum_to_size(x_shape) if need[0] else None
        d_xp = (d_xps * inv_len).sum_to_size(xp_shape) if need[1] else None
        return d_x, d_xp, d_log_sig, d_log_len

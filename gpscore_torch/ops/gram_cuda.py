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

Dispatch is by device alone: a CPU tensor takes the plain version (the
cross-term form of `gpscore/ops/kernels.py:28-40,54-64`, so CPU results track
the JAX package), a CUDA tensor launches the kernel or raises. ``LAUNCHES``
counts kernel launches, so a run can show that it went through the kernels;
a loop that replays a captured CUDA graph adds its replays with
:func:`add_launches`.

A leading batch axis, the counterpart of a ``pl.pallas_call`` under
``jax.vmap`` (which gets an extra grid axis from Pallas's batching rule):
xs [B, n, d], xps [B, m, d], sig [B] and g [B, n, m] give K [B, n, m] in one
launch, each batch's Gram independent of the others and bitwise what an
unbatched launch on its inputs gives. An input may also come unbatched
beside batched ones (xs [n, d], sig one value): every batch shares it, at a
batch stride of 0. A call with no 3-D input is the unbatched call. The
kernels take at most MAX_BATCH Grams a launch (the grid's z extent); a call
of more launches them in consecutive chunks (:func:`batch_chunks`), each
planned as a call of its own size, so a call of at most MAX_BATCH is one
launch and every Gram of a larger call is computed as in a call of its
chunk alone.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gpscore_torch.ops import _build

# Kernel launches by kernel: a wrapper adds one where it launches, and
# add_launches adds the replays of a graph that captured such launches.
LAUNCHES = {"fwd": 0, "bwd_rows": 0, "bwd_cols": 0}
MAX_D = 64  # the kernels' limit on the input dimension (csrc/gram.cu kMaxD)
THREADS = 256  # threads per block of every kernel (kThreads)
COLS_TILE = 32  # gram_bwd_cols: columns per block (csrc/gram.cu kColsTile)
COLS_STAGE_ROWS = 64  # gram_bwd_cols: rows per shared-memory stage (kColsStageRows)
ROWS_MAX_STEP = 256  # gram_bwd_rows: most columns a block takes per trip (32 lanes x 8 warps)
ROWS_MIN_STEP = 4  # gram_bwd_rows: fewest columns a block takes per trip, where m allows
ROWS_STAGE_FLOATS = 8192  # gram_bwd_rows: a shared-memory stage of xps rows and g tile, 32 KB
ROWS_CHUNK_MIN_COLS = 1024  # gram_bwd_rows: fewest columns of a chunk, when there are several
FWD_COLS_PER_THREAD = 4  # gram_fwd: one float4 of a row per thread (kFwdColsPerThread)
FWD_COL_THREADS = (8, 16, 32, 64)  # gram_fwd: the column-thread counts it takes
FWD_ROWS_PER_THREAD = (8, 4, 2, 1)  # gram_fwd: its instantiations, most rows first
MAX_BATCH = 65535  # Grams a launch: the grid's z extent (csrc/gram.cu bad_batch)

# The card's peaks for the roofline bound (NVIDIA's H100 SXM data sheet, dense,
# at the 700 W limit): device memory bandwidth, and fp32 outside the tensor
# cores (the kernels use no tensor cores).
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12


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


def roofline(kernel: str, n: int, m: int, d: int, out_bytes: int = 4,
             diag: bool = False, batch: int = 1, shared_x: bool = False) -> Roofline:
    """Roofline bound of one call of ``kernel`` ("gram_fwd", "gram_bwd_rows"
    or "gram_bwd_cols") at K of n x m on d inputs, ``batch`` such Grams in
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
    FMAs)."""
    if shared_x and n != m:
        raise ValueError(f"shared_x needs a square K, not {n} x {m}")
    inputs = n * d + (0 if shared_x else m * d) + 1
    out = 0
    if kernel == "gram_fwd":
        floats, flops = inputs + int(diag), (3 * d + 3) * n * m
        out = out_bytes * n * m
    elif kernel == "gram_bwd_rows":
        floats, flops = inputs + n * m + n * d + n, (6 * d + 6) * n * m
    elif kernel == "gram_bwd_cols":
        floats, flops = inputs + n * m + m * d, (6 * d + 6) * n * m
    else:
        raise ValueError(f"no roofline for kernel {kernel!r}")
    nbytes, flops = batch * (4 * floats + out), batch * flops
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOP_PER_S
    return Roofline(nbytes, flops, max(t_bytes, t_ops) * 1e6,
                    "bytes" if t_bytes >= t_ops else "operations")


class FwdPlan(NamedTuple):
    """How ``gram_fwd`` tiles K: a block of THREADS threads is col_threads x
    (THREADS / col_threads); a thread owns FWD_COLS_PER_THREAD columns and
    rows_per_thread rows."""

    col_threads: int
    rows_per_thread: int
    launches: int  # kernel launches per call


def fwd_plan(n: int, m: int, d: int, sms: int, batch: int = 1) -> FwdPlan:
    """The tiling of ``gram_fwd`` on a card with ``sms`` multiprocessors,
    for ``batch`` Grams in one launch.

    The narrowest column tile that covers m (at most 256 columns), then the
    most rows per thread that still gives every SM two blocks, counting the
    tiles of every batch: 8 where K is megabytes (32 x 256 outputs, 32 KB, a
    block), 1 at the main path's small Grams, whose time is the launch's."""
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
                   launches=int(n > 0 and m > 0 and batch > 0))


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


def _round_up(v: int, k: int) -> int:
    return -(-v // k) * k


def bwd_rows_plan(n: int, m: int, d: int, sms: int, batch: int = 1) -> BwdRowsPlan:
    """The tiling of ``gram_bwd_rows`` on a card with ``sms`` multiprocessors,
    for ``batch`` Grams in one launch, whose row tiles count together when
    they fill the card (at B = 16 and 500 x 20: 8 columns a trip, 16 row
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
    stage."""
    resident = sms * THREADS * (2 if d <= 16 else 1)
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
    xps_pitch = ((d + 3) // 4 | 1) * 4
    cap = max(32, (ROWS_STAGE_FLOATS - rows_tile * g_pad) // (xps_pitch + rows_tile) // 32 * 32)
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


def bwd_cols_plan(n: int, m: int, d: int, sms: int, batch: int = 1) -> BwdColsPlan:
    """The chunking of ``gram_bwd_cols`` on a card with ``sms`` multiprocessors,
    for ``batch`` Grams in one launch (their stage-tiles count together).

    A block reduces whole stages of COLS_STAGE_ROWS rows. It takes one stage
    while the grid has fewer stage-tiles than twice ``sms`` (so a tall-skinny
    call fills the card: 9700 x 20 gives 152 blocks on 132 SMs), and more,
    double-buffered, when there is work for that many blocks several times
    over. The chunks are summed inside the same launch, so a call is always
    one launch."""
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


def batch_chunks(batch: int):
    """The launches of a call of ``batch`` Grams, as (first Gram, Grams): one
    launch up to MAX_BATCH, else consecutive launches of MAX_BATCH and one of
    the rest. A call of no Grams is one empty chunk."""
    if batch <= MAX_BATCH:
        return [(0, batch)]
    return [(s, min(MAX_BATCH, batch - s)) for s in range(0, batch, MAX_BATCH)]


def _at(t, start: int, bstride: int) -> int:
    """``t``'s data pointer at Gram ``start`` of its batch (batch stride
    ``bstride`` elements; 0 for a shared input, which every chunk reads whole)."""
    return t.data_ptr() + start * bstride * t.element_size()


def _check(xs, xps, sig, g=None) -> Optional[int]:
    """Raise on what the kernels do not take: fp32, row-major contiguous,
    [n, d] / [m, d] with 1 <= d <= MAX_D, one sig value, g [n, m], or the
    same with a leading batch axis on any of xs, xps and g ([B, n, d],
    [B, m, d], [B, n, m]; B the same on all that have it) and sig one value
    or B. Returns B, or None for an unbatched call."""
    tensors = [xs, xps, sig] + ([] if g is None else [g])
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"gram kernel takes float32, got {t.dtype}")
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
    d = xs.shape[-1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"gram kernel takes 1 <= d <= {MAX_D}, got d = {d}")
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


def _raise_if_failed(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


@functools.lru_cache(maxsize=1024)
def _device_plan(plan, device, n, m, d, batch=1):
    """``plan`` (:func:`fwd_plan`, :func:`bwd_rows_plan`, :func:`bwd_cols_plan`)
    for the card ``device``, looked up once per shape and batch."""
    return plan(n, m, d, torch.cuda.get_device_properties(device).multi_processor_count, batch)


# The backward kernels' workspace by (device, stream), shared by both: the
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


def _workspace(device, stream, tiles, scratch_shape, batch=1):
    tiles *= batch
    floats = 0 if scratch_shape is None else batch * math.prod(scratch_shape)
    ws = _WORKSPACES.get((device, stream))
    if ws is None or ws[0].numel() < tiles or ws[1].numel() < floats:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the Gram backward's workspace would grow during a CUDA graph capture "
                f"(to {tiles} tickets, {floats} scratch floats): run the step once on the "
                "capture stream before capturing it")
        tiles = max(tiles, 1 if ws is None else ws[0].numel())
        floats = max(floats, 1 if ws is None else ws[1].numel())
        ws = (torch.zeros(tiles, dtype=torch.int32, device=device),
              torch.empty(floats, dtype=torch.float32, device=device))
        _WORKSPACES[(device, stream)] = ws
    return ws


# gram_fwd's output types, as csrc/gram.cu numbers them.
OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def gram_fwd_cuda(xs, xps, sig, out_dtype=None, diag_add=None):
    """K [n, m] (or [B, n, m]) from the forward kernel, one launch a chunk
    of :func:`batch_chunks`, tiled by :func:`fwd_plan`, in ``out_dtype``
    (float32, None, bfloat16 or float16), with the scalar tensor
    ``diag_add`` added where i == j before the one rounding: inside the
    kernel for a 2-byte K, by one fp32 add after it for an fp32 K (the fp32
    kernel carries no diagonal code)."""
    _require_cuda(xs)
    batch = _check(xs, xps, sig)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if out_dtype not in OUT_TYPES:
        raise TypeError(f"gram_fwd writes {sorted(map(str, OUT_TYPES))}, not {out_dtype}")
    if diag_add is not None and diag_add.numel() != 1:
        raise ValueError(f"diag_add must hold one value, got shape {tuple(diag_add.shape)}")
    if diag_add is not None:
        _check(xs, xps, diag_add)
    lib = _build.load_library()
    n, d = xs.shape[-2:]
    m = xps.shape[-2]
    shape = (n, m) if batch is None else (batch, n, m)
    out = torch.empty(shape, dtype=out_dtype, device=xs.device)
    chunks = [(start, size, _device_plan(fwd_plan, xs.device, n, m, d, size))
              for start, size in batch_chunks(batch or 1)]
    if not chunks[0][2].launches:  # an empty K
        return out
    in_kernel = diag_add is not None and out_dtype != torch.float32
    bs = [_bstride(t, batch) for t in (xs, xps, sig, out)]
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        for start, size, plan in chunks:
            ptrs = [_at(t, start, b) for t, b in zip((xs, xps, sig, out), bs)]
            rc = lib.gram_fwd(*ptrs[:3], diag_add.data_ptr() if in_kernel else None, ptrs[3],
                              n, m, d, plan.col_threads, plan.rows_per_thread,
                              OUT_TYPES[out_dtype], size, *bs, stream)
            _raise_if_failed("gram_fwd", rc)
            LAUNCHES["fwd"] += 1
    if diag_add is not None and not in_kernel:
        out.diagonal(dim1=-2, dim2=-1).add_(diag_add)
    return out


def gram_bwd_rows_cuda(xs, xps, sig, g):
    """(d_xs, rowsum) from the row kernel of the backward: one launch a
    chunk of :func:`batch_chunks`, tiled by :func:`bwd_rows_plan`; [B, n, d]
    and [B, n] for a batched call."""
    _require_cuda(xs)
    batch = _check(xs, xps, sig, g)
    lib = _build.load_library()
    n, d = xs.shape[-2:]
    m = xps.shape[-2]
    lead = () if batch is None else (batch,)
    d_xs = torch.empty((*lead, n, d), dtype=torch.float32, device=xs.device)
    row = torch.empty((*lead, n), dtype=torch.float32, device=xs.device)
    chunks = [(start, _device_plan(bwd_rows_plan, xs.device, n, m, d, size))
              for start, size in batch_chunks(batch or 1)]
    if not chunks[0][1].launches:  # no rows
        return d_xs, row
    bs = [_bstride(t, batch) for t in (xs, xps, sig, g, d_xs)] + [0 if batch is None else n]
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        for _, plan in chunks:  # one workspace, sized for the largest chunk
            ticket, scratch = _workspace(xs.device, stream, plan.row_tiles, plan.scratch_shape,
                                         plan.batch)
        for start, plan in chunks:
            ptrs = [_at(t, start, b) for t, b in zip((xs, xps, sig, g, d_xs, row), bs)]
            rc = lib.gram_bwd_rows(*ptrs, scratch.data_ptr(), ticket.data_ptr(), n, m, d,
                                   plan.lanes_per_row, plan.slices, plan.stage_cols,
                                   plan.chunk_cols, plan.batch, *bs, stream)
            _raise_if_failed("gram_bwd_rows", rc)
            LAUNCHES["bwd_rows"] += 1
    return d_xs, row


def gram_bwd_cols_cuda(xs, xps, sig, g):
    """d_xps from the column kernel of the backward: one launch a chunk of
    :func:`batch_chunks`, cut by :func:`bwd_cols_plan`; [B, m, d] for a
    batched call."""
    _require_cuda(xs)
    batch = _check(xs, xps, sig, g)
    lib = _build.load_library()
    n, d = xs.shape[-2:]
    m = xps.shape[-2]
    lead = () if batch is None else (batch,)
    d_xps = torch.empty((*lead, m, d), dtype=torch.float32, device=xs.device)
    chunks = [(start, _device_plan(bwd_cols_plan, xs.device, n, m, d, size))
              for start, size in batch_chunks(batch or 1)]
    if not chunks[0][1].launches:  # no columns
        return d_xps
    bs = [_bstride(t, batch) for t in (xs, xps, sig, g, d_xps)]
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        for _, plan in chunks:  # one workspace, sized for the largest chunk
            ticket, scratch = _workspace(xs.device, stream, plan.col_tiles, plan.scratch_shape,
                                         plan.batch)
        for start, plan in chunks:
            ptrs = [_at(t, start, b) for t, b in zip((xs, xps, sig, g, d_xps), bs)]
            rc = lib.gram_bwd_cols(*ptrs, scratch.data_ptr(), ticket.data_ptr(), n, m, d,
                                   plan.chunk_rows, plan.batch, *bs, stream)
            _raise_if_failed("gram_bwd_cols", rc)
            LAUNCHES["bwd_cols"] += 1
    return d_xps


def gram_bwd_cuda(xs, xps, sig, g):
    """(d_xs, d_xps, rowsum) from the two backward kernels."""
    d_xs, row = gram_bwd_rows_cuda(xs, xps, sig, g)
    return d_xs, gram_bwd_cols_cuda(xs, xps, sig, g), row


def gram_fwd(xs, xps, sig, out_dtype=None, diag_add=None):
    """K of pre-scaled inputs (in ``out_dtype``, with ``diag_add`` on the
    diagonal): the kernel on CUDA, the plain version on CPU."""
    if xs.device.type == "cpu":
        return gram_fwd_plain(xs, xps, sig, out_dtype, diag_add)
    return gram_fwd_cuda(xs, xps, sig, out_dtype, diag_add)


def gram_bwd(xs, xps, sig, g):
    """(d_xs, d_xps, rowsum): the kernels on CUDA, the plain version on CPU."""
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

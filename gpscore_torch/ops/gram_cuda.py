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
counts kernel launches, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from gpscore_torch.ops import _build

# Kernel launches by kernel; a launch adds one here and nothing else does.
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

# The card's peaks for the roofline bound (NVIDIA's H100 SXM data sheet, dense,
# at the 700 W limit): device memory bandwidth, and fp32 outside the tensor
# cores (the kernels use no tensor cores).
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Roofline(NamedTuple):
    """The least time an H100 could take for one call's work."""

    bytes: int  # each input read once, each output written once
    flops: int
    bound_us: float  # the larger of bytes / bandwidth and flops / fp32 peak
    bound_by: str  # "bytes" or "operations"


def roofline(kernel: str, n: int, m: int, d: int) -> Roofline:
    """Roofline bound of one call of ``kernel`` ("gram_fwd", "gram_bwd_rows"
    or "gram_bwd_cols") at K of n x m on d inputs.

    Bytes: xs [n, d], xps [m, d] and sig are read by all three; the backward
    kernels also read g [n, m]; outputs are K [n, m] (forward), d_xs [n, d]
    and rowsum [n] (rows), d_xps [m, d] (columns). FLOPs per element of K:
    3d + 3 for the forward (d differences and d FMAs, the scale, the exp and
    sig), 6d + 6 for either backward half (the forward's, W = g * K, the sum
    of W, d more differences and d more FMAs)."""
    inputs = n * d + m * d + 1
    if kernel == "gram_fwd":
        floats, flops = inputs + n * m, (3 * d + 3) * n * m
    elif kernel == "gram_bwd_rows":
        floats, flops = inputs + n * m + n * d + n, (6 * d + 6) * n * m
    elif kernel == "gram_bwd_cols":
        floats, flops = inputs + n * m + m * d, (6 * d + 6) * n * m
    else:
        raise ValueError(f"no roofline for kernel {kernel!r}")
    nbytes = 4 * floats
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


def fwd_plan(n: int, m: int, d: int, sms: int) -> FwdPlan:
    """The tiling of ``gram_fwd`` on a card with ``sms`` multiprocessors.

    The narrowest column tile that covers m (at most 256 columns), then the
    most rows per thread that still gives every SM two blocks: 8 where K is
    megabytes (32 x 256 outputs, 32 KB, a block), 1 at the main path's small
    Grams, whose time is the launch's."""
    col_threads = next((c for c in FWD_COL_THREADS if FWD_COLS_PER_THREAD * c >= m),
                       FWD_COL_THREADS[-1])
    col_tile = FWD_COLS_PER_THREAD * col_threads
    row_groups = THREADS // col_threads
    col_tiles = -(-m // col_tile)
    for rt in FWD_ROWS_PER_THREAD:
        blocks = -(-n // (row_groups * rt)) * col_tiles
        if blocks >= 2 * sms:
            break
    return FwdPlan(col_threads=col_threads, rows_per_thread=rt, launches=int(n > 0 and m > 0))


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
    row_tiles: int  # blocks along the rows: one ticket each when n_chunks > 1
    scratch_shape: Optional[Tuple[int, int, int]]  # per-chunk partials; None for one chunk
    launches: int  # kernel launches per call


def _round_up(v: int, k: int) -> int:
    return -(-v // k) * k


def bwd_rows_plan(n: int, m: int, d: int, sms: int) -> BwdRowsPlan:
    """The tiling of ``gram_bwd_rows`` on a card with ``sms`` multiprocessors.

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
    while step > ROWS_MIN_STEP and n * step > resident:
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
    if 0 < row_tiles < sms:
        n_chunks = max(1, min(sms // row_tiles, m // ROWS_CHUNK_MIN_COLS))
    chunk_cols = -(-max(m, 1) // n_chunks)
    stage_cols = min(cap, _round_up(chunk_cols, 32))
    chunk_cols = _round_up(chunk_cols, stage_cols)
    n_chunks = -(-max(m, 1) // chunk_cols)
    return BwdRowsPlan(lanes_per_row=lanes, slices=slices, stage_cols=stage_cols,
                       chunk_cols=chunk_cols, n_chunks=n_chunks, row_tiles=row_tiles,
                       scratch_shape=(n_chunks, n, d + 1) if n_chunks > 1 else None,
                       launches=int(n > 0))


class BwdColsPlan(NamedTuple):
    """How ``gram_bwd_cols`` splits K: column tiles x row chunks, one block each."""

    chunk_rows: int  # rows of K per block, a multiple of COLS_STAGE_ROWS
    n_chunks: int
    col_tiles: int
    blocks: int
    scratch_shape: Optional[Tuple[int, int, int]]  # per-chunk partials; None for one chunk
    launches: int  # kernel launches per call


def bwd_cols_plan(n: int, m: int, d: int, sms: int) -> BwdColsPlan:
    """The chunking of ``gram_bwd_cols`` on a card with ``sms`` multiprocessors.

    A block reduces whole stages of COLS_STAGE_ROWS rows. It takes one stage
    while the grid has fewer stage-tiles than twice ``sms`` (so a tall-skinny
    call fills the card: 9700 x 20 gives 152 blocks on 132 SMs), and more,
    double-buffered, when there is work for that many blocks several times
    over. The chunks are summed inside the same launch, so a call is always
    one launch."""
    col_tiles = -(-m // COLS_TILE)
    stages = max(1, -(-n // COLS_STAGE_ROWS))
    per_chunk = max(1, stages * col_tiles // sms)
    n_chunks = -(-stages // per_chunk)
    return BwdColsPlan(
        chunk_rows=per_chunk * COLS_STAGE_ROWS,
        n_chunks=n_chunks,
        col_tiles=col_tiles,
        blocks=col_tiles * n_chunks,
        scratch_shape=(n_chunks, m, d) if n_chunks > 1 else None,
        launches=int(m > 0),
    )


# ---- plain versions (CPU path, and the kernels' oracle on the card) ---------


def gram_fwd_plain(xs, xps, sig):
    """sig * exp(0.5 (2 xs.xps^T - |xs|^2 - |xps|^2)): the cross-term form of
    the JAX ``ard_gram`` on pre-scaled inputs."""
    neg_d2 = (
        2.0 * torch.matmul(xs, xps.T)
        - torch.sum(xs * xs, dim=-1, keepdim=True)
        - torch.sum(xps * xps, dim=-1, keepdim=True).T
    )
    return sig * torch.exp(0.5 * neg_d2)


def gram_bwd_rows_plain(xs, xps, sig, g):
    """(d_xs, rowsum): d_xs = W xps - rowsum(W) xs, W = g * K
    (`gram_pallas.py:116-125`)."""
    W = g * gram_fwd_plain(xs, xps, sig)
    row = torch.sum(W, dim=1)
    return torch.matmul(W, xps) - row[:, None] * xs, row


def gram_bwd_cols_plain(xs, xps, sig, g):
    """d_xps = W^T xs - colsum(W) xps, W = g * K (`gram_pallas.py:124-126`)."""
    W = g * gram_fwd_plain(xs, xps, sig)
    col = torch.sum(W, dim=0)
    return torch.matmul(W.T, xs) - col[:, None] * xps


def gram_bwd_plain(xs, xps, sig, g):
    """(d_xs, d_xps, rowsum) of the backward, plain."""
    d_xs, row = gram_bwd_rows_plain(xs, xps, sig, g)
    return d_xs, gram_bwd_cols_plain(xs, xps, sig, g), row


# ---- kernel wrappers ---------------------------------------------------------


def _check(xs, xps, sig, g=None):
    """Raise on what the kernels do not take: fp32, row-major contiguous,
    [n, d] / [m, d] with 1 <= d <= MAX_D, one sig value, g [n, m]."""
    tensors = [xs, xps, sig] + ([] if g is None else [g])
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"gram kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("gram kernel takes contiguous tensors")
        if t.device != xs.device:
            raise ValueError(f"gram kernel inputs on {t.device} and {xs.device}")
    if xs.dim() != 2 or xps.dim() != 2 or xs.shape[1] != xps.shape[1]:
        raise ValueError(f"gram kernel takes [n, d] and [m, d], got {tuple(xs.shape)}, "
                         f"{tuple(xps.shape)}")
    if not 1 <= xs.shape[1] <= MAX_D:
        raise ValueError(f"gram kernel takes 1 <= d <= {MAX_D}, got d = {xs.shape[1]}")
    if sig.numel() != 1:
        raise ValueError(f"sig must hold one value, got shape {tuple(sig.shape)}")
    if g is not None and tuple(g.shape) != (xs.shape[0], xps.shape[0]):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != "
                         f"{(xs.shape[0], xps.shape[0])}")


def _require_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"gram kernel takes CUDA tensors, got {t.device}")


def _raise_if_failed(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


@functools.lru_cache(maxsize=1024)
def _device_plan(plan, device, n, m, d):
    """``plan`` (:func:`fwd_plan`, :func:`bwd_rows_plan`, :func:`bwd_cols_plan`)
    for the card ``device``, looked up once per shape."""
    return plan(n, m, d, torch.cuda.get_device_properties(device).multi_processor_count)


# The backward kernels' workspace by (device, stream), shared by both: the
# tickets (one int per tile, 0 between launches, since a kernel's last block
# of a tile sets its ticket back) and the scratch of per-chunk partials.
# Launches that share them must run in order, which one stream guarantees.
# Both only grow.
_WORKSPACES = {}


def _workspace(device, stream, tiles, scratch_shape):
    floats = 0 if scratch_shape is None else math.prod(scratch_shape)
    ws = _WORKSPACES.get((device, stream))
    if ws is None or ws[0].numel() < tiles or ws[1].numel() < floats:
        tiles = max(tiles, 1 if ws is None else ws[0].numel())
        floats = max(floats, 1 if ws is None else ws[1].numel())
        ws = (torch.zeros(tiles, dtype=torch.int32, device=device),
              torch.empty(floats, dtype=torch.float32, device=device))
        _WORKSPACES[(device, stream)] = ws
    return ws


def gram_fwd_cuda(xs, xps, sig):
    """K [n, m] from the forward kernel, tiled by :func:`fwd_plan`."""
    _require_cuda(xs)
    _check(xs, xps, sig)
    lib = _build.load_library()
    n, d = xs.shape
    m = xps.shape[0]
    plan = _device_plan(fwd_plan, xs.device, n, m, d)
    out = torch.empty((n, m), dtype=torch.float32, device=xs.device)
    if not plan.launches:  # an empty K
        return out
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gram_fwd(xs.data_ptr(), xps.data_ptr(), sig.data_ptr(), out.data_ptr(),
                          n, m, d, plan.col_threads, plan.rows_per_thread, stream)
    _raise_if_failed("gram_fwd", rc)
    LAUNCHES["fwd"] += 1
    return out


def gram_bwd_rows_cuda(xs, xps, sig, g):
    """(d_xs, rowsum) from the row kernel of the backward: one launch, tiled
    by :func:`bwd_rows_plan`."""
    _require_cuda(xs)
    _check(xs, xps, sig, g)
    lib = _build.load_library()
    n, d = xs.shape
    m = xps.shape[0]
    plan = _device_plan(bwd_rows_plan, xs.device, n, m, d)
    d_xs = torch.empty_like(xs)
    row = torch.empty((n,), dtype=torch.float32, device=xs.device)
    if not plan.launches:  # no rows
        return d_xs, row
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        ticket, scratch = _workspace(xs.device, stream, plan.row_tiles, plan.scratch_shape)
        rc = lib.gram_bwd_rows(xs.data_ptr(), xps.data_ptr(), sig.data_ptr(), g.data_ptr(),
                               d_xs.data_ptr(), row.data_ptr(), scratch.data_ptr(),
                               ticket.data_ptr(), n, m, d, plan.lanes_per_row, plan.slices,
                               plan.stage_cols, plan.chunk_cols, stream)
    _raise_if_failed("gram_bwd_rows", rc)
    LAUNCHES["bwd_rows"] += 1
    return d_xs, row


def gram_bwd_cols_cuda(xs, xps, sig, g):
    """d_xps from the column kernel of the backward: one launch, chunked by
    :func:`bwd_cols_plan`."""
    _require_cuda(xs)
    _check(xs, xps, sig, g)
    lib = _build.load_library()
    n, d = xs.shape
    m = xps.shape[0]
    plan = _device_plan(bwd_cols_plan, xs.device, n, m, d)
    d_xps = torch.empty_like(xps)
    if not plan.launches:  # no columns
        return d_xps
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        ticket, scratch = _workspace(xs.device, stream, plan.col_tiles, plan.scratch_shape)
        rc = lib.gram_bwd_cols(xs.data_ptr(), xps.data_ptr(), sig.data_ptr(), g.data_ptr(),
                               d_xps.data_ptr(), scratch.data_ptr(), ticket.data_ptr(),
                               n, m, d, plan.chunk_rows, stream)
    _raise_if_failed("gram_bwd_cols", rc)
    LAUNCHES["bwd_cols"] += 1
    return d_xps


def gram_bwd_cuda(xs, xps, sig, g):
    """(d_xs, d_xps, rowsum) from the two backward kernels."""
    d_xs, row = gram_bwd_rows_cuda(xs, xps, sig, g)
    return d_xs, gram_bwd_cols_cuda(xs, xps, sig, g), row


def gram_fwd(xs, xps, sig):
    """K of pre-scaled inputs: the kernel on CUDA, the plain version on CPU."""
    if xs.device.type == "cpu":
        return gram_fwd_plain(xs, xps, sig)
    return gram_fwd_cuda(xs, xps, sig)


def gram_bwd(xs, xps, sig, g):
    """(d_xs, d_xps, rowsum): the kernels on CUDA, the plain version on CPU."""
    if xs.device.type == "cpu":
        return gram_bwd_plain(xs, xps, sig, g)
    return gram_bwd_cuda(xs, xps, sig, g)


def _scale_inputs(x, xp, log_signal_sq, log_length):
    inv_len = torch.exp(-log_length.reshape(1, -1))
    return (x * inv_len).contiguous(), (xp * inv_len).contiguous(), torch.exp(log_signal_sq)


class ArdGram(torch.autograd.Function):
    """ARD Gram K(x, xp) with the kernel backward (`gram_pallas.py:96-136`)."""

    @staticmethod
    def forward(ctx, x, xp, log_signal_sq, log_length):
        xs, xps, sig = _scale_inputs(x, xp, log_signal_sq, log_length)
        # Only the O(nd) scaled inputs are saved; the backward recomputes K.
        ctx.save_for_backward(xs, xps, sig, log_length)
        return gram_fwd(xs, xps, sig)

    @staticmethod
    def backward(ctx, g):
        xs, xps, sig, log_length = ctx.saved_tensors
        # The cotangent often arrives transposed (V = tri_solve(L, K_fu^T)^T
        # in the FITC terms); the kernels take it row-major.
        d_xs, d_xps, row = gram_bwd(xs, xps, sig, g.contiguous())
        d_log_sig = torch.sum(row).reshape(sig.shape)
        inv_len = torch.exp(-log_length.reshape(1, -1))
        d_log_len = -(torch.sum(d_xs * xs, dim=0) + torch.sum(d_xps * xps, dim=0))
        if log_length.numel() != d_log_len.numel():  # one length shared by all dims
            d_log_len = d_log_len.sum()
        return d_xs * inv_len, d_xps * inv_len, d_log_sig, d_log_len.reshape(log_length.shape)

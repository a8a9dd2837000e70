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
COLS_TILE = 32  # gram_bwd_cols: columns per block (csrc/gram.cu kColsTile)
COLS_STAGE_ROWS = 64  # gram_bwd_cols: rows per shared-memory stage (kColsStageRows)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
        launches=1,
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


def gram_fwd_cuda(xs, xps, sig):
    """K [n, m] from the forward kernel."""
    _require_cuda(xs)
    _check(xs, xps, sig)
    lib = _build.load_library()
    n, d = xs.shape
    m = xps.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gram_fwd(xs.data_ptr(), xps.data_ptr(), sig.data_ptr(),
                          out.data_ptr(), n, m, d, stream)
    _raise_if_failed("gram_fwd", rc)
    LAUNCHES["fwd"] += 1
    return out


def gram_bwd_rows_cuda(xs, xps, sig, g):
    """(d_xs, rowsum) from the row kernel of the backward."""
    _require_cuda(xs)
    _check(xs, xps, sig, g)
    lib = _build.load_library()
    n, d = xs.shape
    m = xps.shape[0]
    d_xs = torch.empty_like(xs)
    row = torch.empty((n,), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gram_bwd_rows(xs.data_ptr(), xps.data_ptr(), sig.data_ptr(),
                               g.data_ptr(), d_xs.data_ptr(), row.data_ptr(),
                               n, m, d, stream)
    _raise_if_failed("gram_bwd_rows", rc)
    LAUNCHES["bwd_rows"] += 1
    return d_xs, row


@functools.lru_cache(maxsize=256)
def _device_plan(device, n, m, d):
    """:func:`bwd_cols_plan` for the card ``device``, looked up once per shape."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return bwd_cols_plan(n, m, d, sms)


# gram_bwd_cols' workspace by (device, stream): the tickets (one int per column
# tile, 0 between launches, since the kernel's last block of a tile sets its
# ticket back) and the scratch of per-chunk partials. Launches that share them
# must run in order, which one stream guarantees. Both only grow.
_WORKSPACES = {}


def _workspace(device, stream, plan):
    tiles = plan.col_tiles
    floats = 0 if plan.scratch_shape is None else math.prod(plan.scratch_shape)
    ws = _WORKSPACES.get((device, stream))
    if ws is None or ws[0].numel() < tiles or ws[1].numel() < floats:
        tiles = max(tiles, 1 if ws is None else ws[0].numel())
        floats = max(floats, 1 if ws is None else ws[1].numel())
        ws = (torch.zeros(tiles, dtype=torch.int32, device=device),
              torch.empty(floats, dtype=torch.float32, device=device))
        _WORKSPACES[(device, stream)] = ws
    return ws


def gram_bwd_cols_cuda(xs, xps, sig, g):
    """d_xps from the column kernel of the backward: one launch, chunked by
    :func:`bwd_cols_plan`."""
    _require_cuda(xs)
    _check(xs, xps, sig, g)
    lib = _build.load_library()
    n, d = xs.shape
    m = xps.shape[0]
    plan = _device_plan(xs.device, n, m, d)
    d_xps = torch.empty_like(xps)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        ticket, scratch = _workspace(xs.device, stream, plan)
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

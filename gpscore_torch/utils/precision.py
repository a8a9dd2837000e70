"""Precision policy: the JAX package's five contraction modes on a CUDA card
(port of `gpscore/utils/precision.py`).

The default, "highest", is IEEE fp32 everywhere: TF32 is off for cuBLAS and
cuDNN (:func:`use_ieee_fp32`, called on import), as the JAX package's
HIGHEST runs exact fp32 passes. The other modes are opt-in, for the large-n
fit, and mapped onto Hopper so:

=========  ========================  ==============================  ================================
mode       storage of the n x n      ``matmul``                      ``matmul_crit`` (Schur updates,
           buffers                                                   the Cholesky's left update)
=========  ========================  ==============================  ================================
highest    fp32                      IEEE fp32 (TF32 off)            IEEE fp32
high       fp32                      3 x TF32 from an inner          IEEE fp32
                                     dimension of 4096 on: a = a_hi
                                     + a_lo, a_hi rounded to TF32,
                                     a_lo = a - a_hi (rounded);
                                     a_hi b_hi + a_hi b_lo + a_lo
                                     b_hi in chunks of 2048 of the
                                     inner dimension, the chunks
                                     summed IEEE; IEEE fp32 below
fast       fp32                      one TF32 pass                   IEEE fp32
bf16       bfloat16                  bf16 operands, fp32 out         the same: one native pass of the
                                     (:func:`matmul_acc32`)          stored values, fp32 accumulation
f16        float16                   f16 operands, fp32 out          the same
=========  ========================  ==============================  ================================

Why 3 x TF32 for "high": JAX's "high" is three bf16 passes at about fp32
grade (1.3e-5 against "highest" on its chip), and the recovery ladder of
:func:`gpscore_torch.fit.train.fit_gd_recovering` relies on it as the
well-conditioned fallback. A product of two TF32 values is exact in fp32, yet
on an NVIDIA H100 (700 W) the three passes over the whole inner dimension
read 3.1e-6 of max(|A| |B|) against float64 at 16384^3, six times IEEE
fp32's 5.2e-7: the tensor cores sum a chain of products in fp32 without
IEEE rounding, an error that grows with the chain's length and that no split
removes. So each pass runs over chunks of _SPLIT_K of the inner dimension,
and the chunks are summed by the products' fp32 epilogue, which is IEEE. The
error then falls with the chunk: 7.0e-7, 3.6e-7, 1.8e-7 and 9.7e-8 at 4096,
2048, 1024 and 512, at 108, 95, 81 and 71 effective TFLOP/s (IEEE: 54).
2048 is under IEEE's error at ~1.8x its rate. One TF32 pass reads 2.1e-5:
that one is "fast" (``chip_smoke.py`` phase 11).

Why "high" runs products with an inner dimension under 4096 IEEE: there (the
in-place pipeline's [block, block] products) one chunk's tensor-core sum is
less exact than IEEE fp32's, and its error enters K_hat^-1 itself. With the
pipeline at 3 x TF32 too, the nlml step's log-length gradient read 1.08e-3
off float64 at n = 30,720, over "highest"'s limit of 1e-3 (the pipeline
IEEE: 2.4e-4), for a step 11% shorter. The long products of the backward
([b, n] x [n, r1], the fold sandwich) take the three passes: there the crps
log-signal gradient reads 4.0e-3 off float64, under "highest"'s own 7.1e-3.

Why the critical products stay IEEE in "high" and "fast" (JAX floors them at
its "high"): the Cholesky's left update sets the factor's accuracy, the
reason the in-place pipeline sums it one panel at a time; its inner
dimension is one panel, where "high" itself is IEEE.

The rules around the table:

- ``torch.backends.cuda.matmul.allow_tf32`` is switched on only inside a
  mode's TF32 product and restored after it, so every other fp32 product
  stays IEEE.
- A matrix-vector product (an output of one row or one column) runs IEEE
  fp32 in every fp32 mode: it is bound by the bytes it reads, so a
  tensor-core pass would cost digits and save no time.
- The critical products (:func:`matmul_crit`) are IEEE fp32 in every fp32
  mode (below).
- In the 2-byte modes the products of fp32 operands (the fold blocks, the
  leaf factors, their O(block^3) products) run IEEE fp32; products of two
  stored operands run one native pass with fp32 accumulation and output
  (``torch.mm(a, b, out_dtype=torch.float32)``, CUDA's ``aten::mm.dtype``),
  never through an fp32 copy of the stored buffer.
- Split operands are cut into row panels of at most ``_SPLIT_ROWS`` rows and
  chunks of ``_SPLIT_K`` of the inner dimension, so no n x n temporary
  exists in any mode: the largest is the right operand's split chunk,
  [2 _SPLIT_K, n].

On the CPU the modes take their plain forms, emulations of the card's
arithmetic: TF32 rounding is a mask of the low 13 mantissa bits with
round-to-nearest (:func:`tf32_round`), and 2-byte operands are upcast one
panel at a time. Since TF32 x TF32 and 2-byte x 2-byte products are exact in
fp32, the emulation equals the card's passes up to the order of summation.

The mode is read when a product runs, which for a CUDA graph is when the
step is captured: a graph keeps the mode it was captured under, as a jitted
JAX function keeps the mode it was traced under.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

MODES = ("highest", "high", "fast", "bf16", "f16")
_MODE = "highest"
_STORAGE = {"bf16": torch.bfloat16, "f16": torch.float16}
TWO_BYTE = (torch.bfloat16, torch.float16)
# Row panels of a split left operand (3 x TF32), and of a 2-byte upcast on
# the CPU.
_SPLIT_ROWS = 2048
# The inner-dimension chunk of one 3 x TF32 accumulation chain (module
# docstring): the chunks' sums are added in IEEE fp32.
_SPLIT_K = 2048
# "high" splits a product into 3 x TF32 passes from this inner dimension on,
# and runs the shorter ones IEEE (module docstring).
_SPLIT_MIN_K = 4096


def use_ieee_fp32() -> None:
    """Switch TF32 off everywhere: fp32 matmuls run as IEEE fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def set_matmul_mode(mode: str) -> None:
    """Select the library-wide contraction mode (module docstring)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    global _MODE
    _MODE = mode
    use_ieee_fp32()


def get_matmul_mode() -> str:
    return _MODE


@contextmanager
def matmul_mode(mode: str):
    """:func:`set_matmul_mode` for the duration of the block."""
    prev = _MODE
    set_matmul_mode(mode)
    try:
        yield
    finally:
        set_matmul_mode(prev)


def storage_dtype() -> torch.dtype:
    """The dtype of the large-n cores' n x n buffers: bfloat16 in "bf16",
    float16 in "f16", float32 otherwise."""
    return _STORAGE.get(_MODE, torch.float32)


def acc_dtype(dtype) -> torch.dtype:
    """The dtype sums over ``dtype`` values are taken in: fp32 for the 2-byte
    storage dtypes, ``dtype`` itself otherwise."""
    return torch.float32 if dtype in TWO_BYTE else dtype


def upcast(t):
    """``t`` in fp32 if it is stored in 2 bytes, else ``t`` itself."""
    return t.to(acc_dtype(t.dtype))


def _passes(crit: bool, k: int):
    """How fp32 operands with inner dimension ``k`` are multiplied: None
    (IEEE), "tf32" or "tf32x3" (module docstring)."""
    if crit or (_MODE == "high" and k < _SPLIT_MIN_K):
        return None
    return {"high": "tf32x3", "fast": "tf32"}.get(_MODE)


@contextmanager
def _tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def tf32_round(a):
    """``a`` rounded to TF32 (10 explicit mantissa bits), to nearest: the low
    13 bits of the fp32 pattern masked after adding half of their range.
    Infinities keep their pattern; NaNs pass through (a payload near all
    ones would carry into the sign). Differentiable as the identity, so a
    TF32 product's gradient is that of the product of the unrounded values
    (a_lo = a - a_hi then carries none)."""
    raw = a.detach()
    hi = torch.where(torch.isnan(raw), raw, _tf32_bits(raw))
    return a + (hi - raw) if a.requires_grad else hi


def _tf32_bits(raw):
    """The rounding of :func:`tf32_round` alone: two passes over the bits."""
    return raw.view(torch.int32).add(0x1000).bitwise_and_(-0x2000).view(torch.float32)


def tf32_split(a):
    """(a_hi, a_lo): a_hi = ``a`` rounded to TF32, a_lo = a - a_hi (exact
    for finite a; a NaN or an infinity leaves a_lo NaN, which the product
    carries)."""
    raw = a.detach()
    hi = _tf32_bits(raw)
    if a.requires_grad:
        hi = a + (hi - raw)
    return hi, a - hi


def _tf32_mm(a, b):
    """One TF32 pass: cuBLAS converts the operands on a card; on the CPU
    they are rounded here and multiplied in fp32."""
    if a.is_cuda:
        with _tf32():
            return torch.matmul(a, b)
    return torch.matmul(tf32_round(a), tf32_round(b))


def _tf32x3_mm(a, b):
    """a @ b in three TF32 passes, the small terms first, one _SPLIT_K chunk
    of the inner dimension at a time (differentiable; any batch shape)."""
    out = None
    for k0 in range(0, a.shape[-1], _SPLIT_K):
        ah, al = tf32_split(a[..., k0:k0 + _SPLIT_K])
        bh, bl = tf32_split(b[..., k0:k0 + _SPLIT_K, :])
        part = _tf32_mm(al, bh) + _tf32_mm(ah, bl)
        part = part + _tf32_mm(ah, bh)
        out = part if out is None else out + part
    return out


def _is_matvec(a, b) -> bool:
    return a.dim() == 1 or b.dim() == 1 or a.shape[-2] == 1 or b.shape[-1] == 1


def _split_into(src, hi, lo) -> None:
    """hi <- ``src`` rounded to TF32, lo <- (src - hi) rounded to TF32, both
    to nearest, into the given views: every operand of the passes is a TF32
    value, so the card's conversion changes nothing and a product is exact."""
    hi_bits = hi.view(torch.int32)
    torch.add(src.view(torch.int32), 0x1000, out=hi_bits)
    hi_bits.bitwise_and_(-0x2000)
    torch.sub(src, hi, out=lo)
    lo.view(torch.int32).add_(0x1000).bitwise_and_(-0x2000)


def _tf32x3_into(out, a, b, alpha=1.0):
    """``out`` += alpha * a @ b in three TF32 passes, for 2-D operands
    outside autograd.

    One _SPLIT_K chunk of the inner dimension at a time: b's row chunk is
    split once into B2 = [b_hi; b_lo] and each _SPLIT_ROWS row panel of a's
    column chunk into A2 = [a_lo | a_hi]; the two small terms are one
    product, A2 @ B2, the large one another, a_hi @ b_hi, and each is added
    to ``out`` by the product's own fp32 epilogue. The tensor cores' fp32
    sum of a chain is less exact than IEEE (module docstring); the chunks
    keep each chain short."""
    K = a.shape[1]
    # One buffer of each for all chunks (a ragged last chunk takes a corner).
    B2_buf = b.new_empty((2 * min(_SPLIT_K, K), b.shape[1]))
    A2_buf = a.new_empty((min(_SPLIT_ROWS, a.shape[0]), 2 * min(_SPLIT_K, K)))
    for k0 in range(0, K, _SPLIT_K):
        c = min(_SPLIT_K, K - k0)
        B2 = B2_buf[:2 * c]
        _split_into(b[k0:k0 + c], B2[:c], B2[c:])
        for i0 in range(0, a.shape[0], _SPLIT_ROWS):
            a_p = a[i0:i0 + _SPLIT_ROWS, k0:k0 + c]
            A2 = A2_buf[:a_p.shape[0], :2 * c]
            _split_into(a_p, A2[:, c:], A2[:, :c])
            o = out[i0:i0 + _SPLIT_ROWS]
            with _tf32():  # a no-op on the CPU, where the operands are TF32 values
                o.addmm_(A2, B2, alpha=alpha)
                o.addmm_(A2[:, c:], B2[:c], alpha=alpha)
    return out


def _fp32_matmul(a, b, crit: bool):
    passes = _passes(crit, a.shape[-1])
    if passes is None or _is_matvec(a, b):
        return torch.matmul(a, b)
    if passes == "tf32":
        return _tf32_mm(a, b)
    if a.dim() != 2 or b.dim() != 2 or (torch.is_grad_enabled()
                                        and (a.requires_grad or b.requires_grad)):
        return _tf32x3_mm(a, b)
    return _tf32x3_into(a.new_zeros((a.shape[0], b.shape[1])), a, b)


def _stored_mm(a, b):
    """a @ b of two 2-byte operands of one dtype, fp32 out: one native pass
    on a card (``aten::mm.dtype``), an upcast of one panel of the inner
    dimension at a time on the CPU."""
    if a.dtype != b.dtype:
        raise TypeError(f"stored operands of two dtypes: {a.dtype}, {b.dtype}")
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    out = a.new_zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[1], _SPLIT_ROWS):
        out.addmm_(a[:, k0:k0 + _SPLIT_ROWS].float(), b[k0:k0 + _SPLIT_ROWS].float())
    return out


def matmul(a, b):
    """The mode's product (module docstring): IEEE fp32 in "highest"."""
    if a.dtype in TWO_BYTE or b.dtype in TWO_BYTE:
        return _stored_mm(a, b)
    return _fp32_matmul(a, b, crit=False)


def matmul_crit(a, b):
    """The product for cancellation-critical accumulations (the Cholesky's
    left update): IEEE fp32 in every fp32 mode, one native pass of two
    stored 2-byte operands."""
    if a.dtype in TWO_BYTE or b.dtype in TWO_BYTE:
        return _stored_mm(a, b)
    return _fp32_matmul(a, b, crit=True)


def matmul_acc32(a, b):
    """a @ b with fp32 accumulation and an fp32 result whatever the operands'
    dtype: two stored 2-byte operands of one dtype take one native pass (no
    n^2 upcast); fp32 operands take :func:`matmul`."""
    return matmul(a, b)


def matmul_split_k(a, b):
    """:func:`matmul_acc32` for 2-D operands with a long inner dimension:
    where the mode multiplies them in IEEE fp32 ("highest", or "high" below
    its split), the inner dimension is summed one _SPLIT_K chunk at a time,
    each chunk's sum added to the fp32 result by the product's epilogue. Every
    other case is :func:`matmul_acc32`'s (the TF32 passes chunk themselves;
    2-byte operands take one native pass).

    Why: cuBLAS runs one chain of fp32 sums over the whole inner dimension,
    and the chain's rounding drifts with its length. On an NVIDIA H100 (700 W)
    the large-n backward's [2048, 30720] x [30720, r1] products read the
    trace of their diagonal blocks 3.2e-5 off float64 at r1 = 30720 and
    8.5e-5 over the narrower r1 of the lower block-triangle (another kernel's
    chain), and 8.0e-6 in chunks of 2048, whose pass takes 625 ms against one
    chain's 609."""
    if (a.dtype in TWO_BYTE or b.dtype in TWO_BYTE or a.shape[1] <= _SPLIT_K
            or _passes(False, a.shape[1]) is not None):
        return matmul_acc32(a, b)
    out = torch.mm(a[:, :_SPLIT_K], b[:_SPLIT_K])
    for k0 in range(_SPLIT_K, a.shape[1], _SPLIT_K):
        out.addmm_(a[:, k0:k0 + _SPLIT_K], b[k0:k0 + _SPLIT_K])
    return out


def addmm_(C, A, B, alpha=1.0, beta=1.0, crit: bool = False):
    """C <- beta C + alpha A @ B in place, C fp32, by the mode's product
    (``crit``: :func:`matmul_crit`'s). In "highest" it is exactly
    ``C.addmm_(A, B, beta=beta, alpha=alpha)``."""
    if A.dtype in TWO_BYTE or B.dtype in TWO_BYTE:
        if beta == 0.0:
            C.zero_()
        elif beta != 1.0:
            C.mul_(beta)
        # Row panels of A: the fp32 product's temporary stays within _SPLIT_ROWS x
        # _SPLIT_K entries, [_SPLIT_ROWS, B's columns] for a B of _SPLIT_K columns
        # or more, taller panels of a narrower B (a panel of 256 columns: one
        # launch for 16,384 rows, not eight).
        rows = max(_SPLIT_ROWS, _SPLIT_ROWS * _SPLIT_K // max(B.shape[-1], 1))
        for i0 in range(0, A.shape[0], rows):
            C[i0:i0 + rows].add_(_stored_mm(A[i0:i0 + rows], B), alpha=alpha)
        return C
    passes = _passes(crit, A.shape[-1])
    if passes is None or _is_matvec(A, B):
        return C.addmm_(A, B, beta=beta, alpha=alpha)
    if passes == "tf32":
        if C.is_cuda:
            with _tf32():
                return C.addmm_(A, B, beta=beta, alpha=alpha)
        return C.addmm_(tf32_round(A), tf32_round(B), beta=beta, alpha=alpha)
    if beta == 0.0:
        C.zero_()
    elif beta != 1.0:
        C.mul_(beta)
    return _tf32x3_into(C, A, B, alpha)

"""Exact int8 x int8 -> int32 convolution of the int8 serving path.

Counterpart of the ``jax.lax.conv_general_dilated(xq, wq, ...,
preferred_element_type=jnp.int32)`` call in the int8 branch of
``conv_block`` (aquaculture_tpu/models/layers.py). The JAX package leaves
that product to XLA, outside any Pallas kernel. PyTorch's ``F.conv2d`` has
no int8 path, so the port runs the convolution as a matrix product. Inputs
are NCHW int8 in channels_last memory (the JAX package's NHWC), weights
OIHW int8, padding explicit as ``((top, bottom), (left, right))`` like
``layers.conv2d``. The output is NCHW int32 in channels_last memory.

Two routes, chosen by the tensors' device as ops/nms.py chooses its
suppression:

- CUDA: ``int8_conv2d_mm``, ``torch._int_mm`` on the tensor cores (int8
  operands, int32 sums, through cuBLASLt). A 1x1 conv is a reshape of the
  NHWC storage to ``(B*H*W, Cin) @ (Cin, Cout)``. Any other kernel (k3/s1,
  k3/s2, the k2 space-to-depth downsample, the k3 stem over 12 channels)
  goes through an NHWC im2col built from strided slices of the zero-padded
  input, one chunk of whole images at a time so that the im2col stays
  within ``IM2COL_BYTES``. K and N are zero-padded to multiples of 8,
  which the card's ``_int_mm`` requires (the 12-channel stem's K = 108
  becomes 112), and M to a multiple of ``ROW_MULTIPLE`` rows: on the H100
  (torch 2.11, CUDA 12.8) cuBLASLt refused (CUBLAS_STATUS_NOT_SUPPORTED)
  every product at N = 64, K = 64 or 112 whose M was not a multiple of 32
  (17 to 400 rows tried), and ran every M that was (PERF.md). The operands
  are fresh or row slices of contiguous storage, so cuBLASLt sees
  row-major matrices.
- CPU: ``int8_conv2d_plain``, ``F.conv2d`` in float64 on the integer
  values, rounded to int32. Each product is at most 127 * 127 and each sum
  has fewer than 2**30 of them, so every partial sum is an integer below
  2**53 and float64 holds it exactly.

A CUDA int8 conv goes through ``_int_mm`` or raises; it never takes the
plain route. ``int8_conv2d_mm`` also runs on CPU tensors (``torch._int_mm``
is exact there), so the tests hold the two routes against each other and
against the JAX package. A fused implicit-GEMM kernel with the dequant,
SiLU and requant epilogue is later perf work (ROADMAP).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Padding = Tuple[Tuple[int, int], Tuple[int, int]]

# largest im2col chunk, in bytes of int8 (whole images per chunk)
IM2COL_BYTES = 1 << 30
# products run on a multiple of this many rows (zero rows appended), which
# also meets the card's M > 16
ROW_MULTIPLE = 32

# calls of each route since the last reset; chip_smoke.py zeroes them around
# the int8 drives to show the card's convs all took _int_mm
mm_calls = 0
plain_calls = 0


def _padding(k: int, padding: Padding | None) -> Padding:
    if padding is None:
        return ((k // 2, k // 2), (k // 2, k // 2))
    (pt, pb), (pl, pr) = padding
    return ((int(pt), int(pb)), (int(pl), int(pr)))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check(xq: torch.Tensor, wq: torch.Tensor) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 inputs and weights, got {xq.dtype} and {wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_conv2d: input {tuple(xq.shape)} (NCHW) does not fit weight {tuple(wq.shape)} (OIHW)")
    if xq.device != wq.device:
        raise ValueError(f"int8_conv2d: input on {xq.device}, weight on {wq.device}")


def _weight_matrix(wq: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """(Cout, Cin, kh, kw) -> (kp, np_) row-major, rows in (kh, kw, cin)
    order (the im2col's columns), zero-padded."""
    cout = wq.shape[0]
    w = wq.permute(2, 3, 1, 0).reshape(-1, cout)
    if w.shape == (kp, np_):
        return w.contiguous()
    out = torch.zeros((kp, np_), dtype=torch.int8, device=wq.device)
    out[: w.shape[0], :cout] = w
    return out


def _int_mm_into(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """out = a @ b in int32, a (M, K) and b (K, N) int8, K and N multiples
    of 8; M is padded with zero rows to a multiple of ROW_MULTIPLE."""
    m = a.shape[0]
    if m % ROW_MULTIPLE == 0:
        torch._int_mm(a, b, out=out)
        return
    padded = torch.zeros((_round_up(m, ROW_MULTIPLE), a.shape[1]), dtype=torch.int8, device=a.device)
    padded[:m] = a
    out.copy_(torch._int_mm(padded, b)[:m])


def int8_conv2d_mm(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                   padding: Padding | None = None) -> torch.Tensor:
    """The matrix-product route (any device; the card's route)."""
    global mm_calls
    _check(xq, wq)
    b, cin, h, w = xq.shape
    cout, _, kh, kw = wq.shape
    (pt, pb), (pl, pr) = _padding(kh, padding)
    ho, wo = (h + pt + pb - kh) // stride + 1, (w + pl + pr - kw) // stride + 1
    k = kh * kw * cin
    kp, np_ = _round_up(k, 8), _round_up(cout, 8)
    wmat = _weight_matrix(wq, kp, np_)
    x = xq.permute(0, 2, 3, 1)  # NHWC; a view when xq is channels_last
    out = torch.empty((b, ho, wo, np_), dtype=torch.int32, device=xq.device)
    mm_calls += 1
    if kh == kw == 1 and stride == 1 and not (pt or pb or pl or pr) and kp == cin:
        _int_mm_into(x.reshape(b * h * w, cin), wmat, out.view(-1, np_))
    else:
        if pt or pb or pl or pr:
            x = F.pad(x, (0, 0, pl, pr, pt, pb))
        per_image = ho * wo * kp
        step = max(1, IM2COL_BYTES // per_image)
        for i in range(0, b, step):
            xi = x[i : i + step]
            n = xi.shape[0]
            alloc = torch.zeros if kp != k else torch.empty
            col = alloc((n, ho, wo, kp), dtype=torch.int8, device=xq.device)
            for u in range(kh):
                for v in range(kw):
                    c0 = (u * kw + v) * cin
                    col[..., c0 : c0 + cin] = xi[:, u : u + stride * (ho - 1) + 1 : stride,
                                                 v : v + stride * (wo - 1) + 1 : stride, :]
            _int_mm_into(col.view(-1, kp), wmat, out[i : i + n].view(-1, np_))
    if np_ != cout:
        out = out[..., :cout]
    return out.permute(0, 3, 1, 2)


def int8_conv2d_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                      padding: Padding | None = None) -> torch.Tensor:
    """The plain route: float64 convolution of the integer values, exact."""
    global plain_calls
    _check(xq, wq)
    (pt, pb), (pl, pr) = _padding(wq.shape[-1], padding)
    x = xq.double()
    pad = (pt, pl)
    if pt != pb or pl != pr:
        x, pad = F.pad(x, (pl, pr, pt, pb)), (0, 0)
    plain_calls += 1
    y = F.conv2d(x, wq.double(), stride=stride, padding=pad)
    return torch.round(y).to(torch.int32)


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                padding: Padding | None = None) -> torch.Tensor:
    """int8 NCHW (channels_last) x int8 OIHW -> exact int32 NCHW: through
    ``torch._int_mm`` on a CUDA tensor, the plain float64 route on a CPU
    tensor, and a ValueError on any other device."""
    if xq.is_cuda:
        return int8_conv2d_mm(xq, wq, stride, padding)
    if xq.device.type == "cpu":
        return int8_conv2d_plain(xq, wq, stride, padding)
    raise ValueError(f"int8_conv2d runs on CUDA or CPU tensors, got {xq.device}")

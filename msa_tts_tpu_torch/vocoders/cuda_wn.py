"""WaveGlow's WN layer between its products: the gate and the
residual/skip sums, each one launch of ``csrc/waveglow_wn.cu`` on CUDA
tensors, with their plain PyTorch versions beside them.

Per layer, with R(·) the rounding to the activation type (module
docstring of ``waveglow.py``, Precision):

- the gate: ``acts = R(R(tanh z₁) · R(sigmoid z₂))``, ``z = R(zc + zd)``
  from the conditioning product's output ``zc`` and the dilated
  convolution's ``zd`` (both (B, L, 2C)), z₁ its first C channels;
- the residual pass: from the res/skip product's output ``rs`` (B, L,
  2C), ``x = R(x + rs_res)`` zeroed at padded positions (the next
  layer's pad mask) and ``skip = R(skip + rs_skip)`` (``rs_skip`` itself
  at the first layer); at the last layer ``rs`` is (B, L, C), x is left
  as it is and skip comes back as float32, the operand ``end`` takes.

The kernels compute what the plain versions' eager ops compute, bit for
bit.  ``cuda_gate`` and ``cuda_residual`` take contiguous CUDA tensors of
one type (bfloat16 or float32) and raise on anything else; there is no
fallback to the plain versions, which ``WaveGlowVocoder.wn`` takes for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..kernels.build import load

# Incremented once per launch of either pass, and nowhere else: a run
# reads it to show that its WN layers went through the kernels (two a
# layer).
WN_LAUNCHES = 0

DTYPES = (torch.bfloat16, torch.float32)


def gate_reference(zc: torch.Tensor, zd: torch.Tensor) -> torch.Tensor:
    """The gate as eager ops: (B, L, 2C), (B, L, 2C) → acts (B, L, C)."""
    z = zc + zd
    C = z.shape[-1] // 2
    return torch.tanh(z[..., :C]) * torch.sigmoid(z[..., C:])


def residual_reference(rs: torch.Tensor, x: torch.Tensor,
                       skip: torch.Tensor | None,
                       pad: torch.Tensor | None = None):
    """The residual pass as eager ops: returns ``(x, skip)`` (module
    docstring); ``skip`` None at the first layer, ``pad`` (B, L, 1) bool
    or None."""
    C = x.shape[-1]
    last = rs.shape[-1] == C
    s = rs if last else rs[..., C:]
    skip = s if skip is None else skip + s
    if last:
        return x, skip.float()
    x = x + rs[..., :C]
    if pad is not None:
        x = x.masked_fill(pad, 0.0)
    return x, skip


@functools.cache
def _lib():
    lib = load("waveglow_wn")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.waveglow_wn_gate.argtypes = [P, P, P, I, I, I, I, P]
    lib.waveglow_wn_gate.restype = I
    lib.waveglow_wn_residual.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    lib.waveglow_wn_residual.restype = I
    lib.waveglow_wn_error_string.argtypes = [I]
    lib.waveglow_wn_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _dims(t: torch.Tensor, name: str):
    """(device, dtype, B, L, width) of a (B, L, width) CUDA tensor of an
    activation type."""
    if t.device.type != "cuda":
        raise ValueError(f"the WN passes need CUDA tensors, {name} is on "
                         f"{t.device}")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{DTYPES}")
    if t.dim() != 3:
        raise ValueError(f"{name} must be (B, L, channels), got "
                         f"{tuple(t.shape)}")
    B, L, W = t.shape
    if B * L * W >= 2 ** 31:
        raise ValueError(f"{name} has {B * L * W} elements, the passes "
                         "index fewer than 2^31")
    return t.device, t.dtype, B, L, W


def _vec_bytes(C: int, ts) -> int:
    """The widest vector (16, 8 or 4 bytes) that divides a row of C
    channels and every tensor's address, scaled by each tensor's element
    size against ``ts[0]``'s."""
    unit = ts[0].element_size()
    for v in (16, 8, 4):
        if (C * unit) % v == 0 and all(
                t.data_ptr() % (v * t.element_size() // unit) == 0
                for t in ts):
            return v
    raise ValueError(f"C={C} and these tensors' addresses admit no vector "
                     "of 4 or more bytes")


def _launched(lib, rc: int, what: str) -> None:
    global WN_LAUNCHES
    if rc != 0:
        raise RuntimeError(f"waveglow_wn {what} failed: "
                           + lib.waveglow_wn_error_string(rc).decode())
    WN_LAUNCHES += 1


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@torch.no_grad()
def cuda_gate(zc: torch.Tensor, zd: torch.Tensor) -> torch.Tensor:
    """:func:`gate_reference` as one launch: zc, zd (B, L, 2C) → acts
    (B, L, C)."""
    device, dtype, B, L, W = _dims(zc, "zc")
    if W % 2:
        raise ValueError(f"zc has {W} channels, expected 2C")
    C = W // 2
    _check("zd", zd, (B, L, W), dtype, device)
    _check("zc", zc, (B, L, W), dtype, device)
    acts = torch.empty((B, L, C), dtype=dtype, device=device)
    vec = _vec_bytes(C, (zc, zd, acts))
    lib = _lib()
    with torch.cuda.device(device):
        rc = lib.waveglow_wn_gate(
            zc.data_ptr(), zd.data_ptr(), acts.data_ptr(), B * L, C,
            int(dtype == torch.bfloat16), vec, _stream(device))
    _launched(lib, rc, "gate")
    return acts


@torch.no_grad()
def cuda_residual(rs: torch.Tensor, x: torch.Tensor,
                  skip: torch.Tensor | None,
                  pad: torch.Tensor | None = None):
    """:func:`residual_reference` as one launch: returns ``(x, skip)``;
    x is updated in place (not at the last layer, where rs is (B, L, C));
    skip in place, except at the first layer (None: a new tensor) and at
    the last (a new float32 tensor).  ``pad`` (B, L, 1) bool or None."""
    device, dtype, B, L, C = _dims(x, "x")
    last = rs.shape[-1] == C
    _check("rs", rs, (B, L, C if last else 2 * C), dtype, device)
    _check("x", x, (B, L, C), dtype, device)
    if skip is not None:
        _check("skip", skip, (B, L, C), dtype, device)
    if pad is not None:
        _check("pad", pad, (B, L, 1), torch.bool, device)
    if last:
        out = torch.empty((B, L, C), dtype=torch.float32, device=device)
    else:
        out = torch.empty_like(x) if skip is None else skip
    if len({t.data_ptr() for t in (rs, x, out)}) < 3 or (
            skip is not None and skip.data_ptr() in (rs.data_ptr(),
                                                     x.data_ptr())):
        raise ValueError("rs, x and skip must be distinct tensors")
    vec = _vec_bytes(C, [t for t in (rs, x, skip, out) if t is not None])
    lib = _lib()
    with torch.cuda.device(device):
        rc = lib.waveglow_wn_residual(
            rs.data_ptr(), x.data_ptr(),
            None if skip is None else skip.data_ptr(), out.data_ptr(),
            None if pad is None else pad.data_ptr(), B * L, C,
            int(dtype == torch.bfloat16), vec, int(last), _stream(device))
    _launched(lib, rc, "residual")
    return x, out

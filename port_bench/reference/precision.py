"""The precisions the reference computes in.

``Precision`` rounds the two operands of every matrix product and
convolution: the weight and the activation going in, each held in
float32 after the rounding, so that the product's sums are float32.
Everything between the products (biases, normalisations,
nonlinearities, the recurrent state) stays float32.

- ``float32``: no rounding (the products run with TF32 off).
- ``tf32``: both operands rounded to TF32's 10-bit significand, the
  type one step below float32 with TF32 off.
- ``bfloat16``: both operands rounded to bfloat16, the type a served
  bfloat16 model's products take, and one step below float32 where TF32
  is on.
- ``float8``: both operands scaled by their largest magnitude to the
  range of float8 e4m3 and rounded to it (one scale per tensor), the
  type one step below bfloat16.  This is the control's precision.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
# the nearest precision below each stated one, where TF32 is on (cuDNN's
# convolutions by PyTorch's default) or the type is not float32
LOWER = {"float32": "bfloat16", "bfloat16": "float8"}


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, E4M3_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """To the nearest TF32 value (13 low significand bits dropped, ties
    away from zero)."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("float32", "tf32", "bfloat16", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self._round = {"float32": lambda x: x, "tf32": _round_tf32,
                       "bfloat16": _round_bf16, "float8": _round_fp8}[name]
        self._cache: dict = {}

    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight as the products see it, rounded once."""
        key = id(t)
        hit = self._cache.get(key)
        if hit is None or hit[0] is not t:
            hit = (t, self._round(t.float()))
            self._cache[key] = hit
        return hit[1]

    def vec(self, t: torch.Tensor) -> torch.Tensor:
        """A bias or a normalisation's vector: bfloat16 below float32
        (a float8 model keeps its vectors in bfloat16)."""
        return t.float() if self.name == "float32" else _round_bf16(t)

    def params(self, sd: dict) -> dict:
        """A ``state_dict`` as a model served at this precision holds it:
        matrices and kernels rounded as weights, vectors by :meth:`vec`."""
        return {k: (v if not v.is_floating_point() else
                    self._round(v.float()) if v.dim() >= 2 else self.vec(v))
                for k, v in sd.items()}

    def x(self, t: torch.Tensor) -> torch.Tensor:
        """An activation going into a product."""
        return self._round(t.float())


@contextlib.contextmanager
def no_tf32():
    """TF32 off for the reference's float32 products, and the flags as
    they were afterwards (the served system runs with them)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags

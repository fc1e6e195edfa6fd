"""The precision a reference computes its products in.

``"f32"``: every matmul and convolution in full f32 (TF32 off).
``"tf32"``: the same with TF32 on: the control for a configuration that
states f32.  ``"fp8"``: both operands of every product rounded to
float8 e4m3 with one scale per tensor (its largest magnitude at 448),
then multiplied in f32: the control for a configuration that states
bf16.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as the products see it."""
        return fp8_round(x) if self.name == "fp8" else x.float()

    @contextlib.contextmanager
    def products(self):
        """TF32 on for ``"tf32"``, off otherwise, restored after."""
        m = torch.backends.cuda.matmul.allow_tf32
        c = torch.backends.cudnn.allow_tf32
        on = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = m
            torch.backends.cudnn.allow_tf32 = c

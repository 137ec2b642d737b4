"""Row LayerNorm: the wrapper of K2 (``csrc/layernorm.cu``) and its plain
version. Port of ``cogstream_tpu/ops/layernorm.py::pallas_layernorm``.

``layernorm`` launches the CUDA kernel for CUDA tensors and runs
``layernorm_plain`` for CPU tensors; there is no other route.
"""

from __future__ import annotations

import torch

from . import kernels


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """f32 mean, centred f32 variance, affine, cast back to x.dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)
            + bias.to(torch.float32)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of x [N, H] (any N, H)."""
    if kernels.plain_route(x):
        return layernorm_plain(x, scale, bias, eps)
    if x.dim() != 2:
        raise ValueError(f"layernorm takes [N, H], got {tuple(x.shape)}")
    N, H = x.shape
    kernels.require(x, "x", x.device)
    kernels.require(scale, "scale", x.device, torch.float32, (H,))
    kernels.require(bias, "bias", x.device, torch.float32, (H,))
    out = torch.empty_like(x)
    if N:
        lib = kernels.library()
        kernels.check(lib.cs_layernorm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            N, H, float(eps), kernels.dtype_code(x), kernels.stream_ptr(x)),
            "cs_layernorm")
        layernorm.launches += 1
    return out


layernorm.launches = 0

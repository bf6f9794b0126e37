"""Wrapper of the flash-attention forward kernel
(``csrc/flash_attention.cu``), with the JAX wrapper's contract.

``flash_attention(q, k, v, causal, block_q, block_k)`` takes q ``(B, H,
Sq, D)`` and k, v ``(B, Hkv, Sk, D)`` and refuses the shapes the JAX
kernel asserts on (``Sq % min(block_q, Sq)``, the same for Sk); the CUDA
kernel's own tile is its choice.  It is an ``autograd.Function`` whose
backward recomputes through the plain version (``ref.py``), as the JAX
``ops.py`` does.  A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.  A fake tensor (the dry-run's trace,
either device) goes through the custom op ``repro_torch::flash_fwd``,
whose fake impl gives the kernel's output alone, shape, type and
strides, and whose FLOP formula counts the kernel's work: ``4 B H D`` a
(query, key) pair of the tiles it visits (:func:`flops`).  Real tensors
take the direct path: a custom op's dispatch costs a first call in each
process seconds of imports.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch import kernels
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 128)
TILE = 64           # the kernel's query rows a block and keys a KV tile
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check_shapes(q, k, v, block_q: int, block_k: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q (B,H,Sq,D), k = v (B,Hkv,Sk,D); got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, h, sq, d = q.shape
    bk_, hkv, sk, dk = k.shape
    if bk_ != b or dk != d or hkv < 1 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"pair (batch, head_dim, heads % kv_heads)")
    bq, bk = min(block_q, sq), min(block_k, sk)
    if bq < 1 or bk < 1 or sq % bq or sk % bk:
        raise ValueError(f"Sq={sq} and Sk={sk} must be multiples of the "
                         f"blocks {bq} and {bk}")


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """What the kernel takes: its head dims and types, on the card."""
    d = q.shape[-1]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v of one type of {_DTYPES}, got {q.dtype} "
                         f"{k.dtype} {v.dtype}")
    kernels.check_cuda(q, k, v)


def _forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors (no autograd)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    _check_kernel(q, k, v)
    # the tensor-core design reads q, k, v through TMA, which takes
    # 16-byte aligned rows: a view that starts off that grid is copied
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    out = torch.empty_like(q)
    kernels.check_operands(q, k, v, out)
    if out.numel():
        kernels.launch("flash_attention.fwd", "flash_fwd", q.device,
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, h, hkv, sq, sk, d,
                       kernels.KIND[q.dtype], int(causal), d ** -0.5)
    return out


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cpu")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> torch.Tensor:
    """The forward: the plain version on the CPU, the kernel on CUDA."""
    return ref.flash_attention(q, k, v, causal).contiguous()


@flash_fwd.register_kernel("cuda")
def _(q, k, v, causal):
    return _forward_kernel(q, k, v, causal)


@flash_fwd.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


def flops(b: int, h: int, sq: int, sk: int, d: int, causal: bool) -> int:
    """The kernel's multiply-adds, twice (QK^T and PV): ``4 B H D`` for
    each (query, key) pair of the tiles it visits.  A causal block of
    query rows ``[q0, q0 + 64)`` visits the key tiles up to its own."""
    pairs = 0
    for q0 in range(0, sq, TILE):
        keys = min(sk, q0 + TILE) if causal else sk
        pairs += min(TILE, sq - q0) * keys
    return 4 * b * h * d * pairs


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
                 **kwargs) -> int:
    b, h, sq, d = q_shape
    return flops(b, h, sq, k_shape[2], d, causal)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if is_fake(q):
            return flash_fwd(q, k, v, causal)
        if q.device.type == "cpu":
            return ref.flash_attention(q, k, v, causal)
        return _forward_kernel(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            prim = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = ref.flash_attention(*prim, causal=ctx.causal)
            grads = torch.autograd.grad(out, prim, g)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, H, Sq, D)."""
    _check_shapes(q, k, v, block_q, block_k)
    if q.device.type != "cpu":
        _check_kernel(q, k, v)
    return _Flash.apply(q, k, v, bool(causal))

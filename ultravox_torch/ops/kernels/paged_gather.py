"""Page gather kernel (``csrc/paged_gather.cu``) and its plain version.

``gather_pages`` replaces ``ultravox_tpu/ops/pallas/paged_gather.py:
gather_pages``: the (L, P, page_size, Hkv, D) k and v pools become
contiguous (L, B, n_per * page_size, Hkv, D) views of each row's pages in
table order. Sentinel ids clamp to P - 1 and every entry of the views is
written. The wrapper takes its plain version (``gather_pages_plain``, an
``index_select`` of the clamped ids) for CPU tensors and launches the kernel
for CUDA tensors; ``gather_pages.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ultravox_torch.ops.kernels import _build
from ultravox_torch.ops.kernels.paged_attention import gather_pages_plain

VEC_BYTES = 16  # the kernel moves 16 bytes per load and store


def gather_pages(
    k_pool: torch.Tensor,  # (L, P, ps, Hkv, D); each page contiguous
    v_pool: torch.Tensor,  # (L, P, ps, Hkv, D), at k_pool's strides
    page_table: torch.Tensor,  # (B, n_per) int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (k_view, v_view), each (L, B, n_per * ps, Hkv, D)."""
    if k_pool.device.type == "cpu":
        return gather_pages_plain(k_pool, page_table), gather_pages_plain(v_pool, page_table)
    _build.require_cuda(k_pool, v_pool, page_table)
    L, P, ps, Hkv, D = k_pool.shape
    B, n_per = page_table.shape
    if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"k and v pools differ: {k_pool.shape} {v_pool.shape}")
    if k_pool.stride() != v_pool.stride() or k_pool.stride()[2:] != (Hkv * D, D, 1):
        raise ValueError("each page must be contiguous, with k and v at the same strides")
    if page_table.dtype != torch.int32 or not page_table.is_contiguous():
        raise TypeError("page_table must be a contiguous int32 tensor")
    es = k_pool.element_size()
    page_bytes = ps * Hkv * D * es
    l_bytes, p_bytes = k_pool.stride(0) * es, k_pool.stride(1) * es
    if any(x % VEC_BYTES for x in (page_bytes, l_bytes, p_bytes, k_pool.data_ptr(),
                                   v_pool.data_ptr())):
        raise ValueError(
            f"gather_pages copies in {VEC_BYTES}-byte units: page {page_bytes} B, strides "
            f"{l_bytes}/{p_bytes} B and both bases must be multiples of {VEC_BYTES}")
    shape = (L, B, n_per * ps, Hkv, D)
    k_out = torch.empty(shape, dtype=k_pool.dtype, device=k_pool.device)
    v_out = torch.empty(shape, dtype=v_pool.dtype, device=v_pool.device)
    lib = _build.library("paged_gather")
    rc = lib.uv_paged_gather(
        _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(k_out), _build.ptr(v_out),
        _build.ptr(page_table), ctypes.c_longlong(l_bytes // VEC_BYTES),
        ctypes.c_longlong(p_bytes // VEC_BYTES), ctypes.c_longlong(page_bytes // VEC_BYTES),
        L, B, n_per, P, _build.stream_ptr(k_pool.device),
    )
    _build.check("paged_gather", rc)
    gather_pages.launches += 1
    return k_out, v_out


gather_pages.launches = 0

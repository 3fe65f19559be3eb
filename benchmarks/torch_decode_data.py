"""Decode-step data for the split-K decode kernels (K2 on a dense cache,
K3 on a page pool) on the CUDA device, shared by ``chip_smoke.py`` and
``benchmarks/torch_decode_variants.py``, which load this file by path.

Every function takes the ``torch`` module first, as ``chip_smoke.py``'s
own do, so that a caller may load this file before it imports torch.
"""
from __future__ import annotations


def rand(torch, gen, shape, dtype):
    """Unit normals from ``gen`` on the device, drawn in fp32."""
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32).to(dtype)


def paged_data(torch, gen, b, hq, hkv, m, d, ps=16):
    """A decode step's data on both layouts, fp32: a dense cache of m slots
    and the same rows scattered into a pool of b * m / ps pages in a random
    page order (tables [b, m / ps])."""
    w = m // ps
    g = hq // hkv
    q = rand(torch, gen, (b, hq, 1, d), torch.float32)
    k = rand(torch, gen, (b, hkv, m, d), torch.float32)
    v = rand(torch, gen, (b, hkv, m, d), torch.float32)
    perm = torch.randperm(b * w, generator=gen, device="cuda")
    k_pages = torch.empty((b * w, ps, hkv, d), device="cuda")
    v_pages = torch.empty_like(k_pages)
    k_pages[perm] = k.reshape(b, hkv, w, ps, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * w, ps, hkv, d)
    v_pages[perm] = v.reshape(b, hkv, w, ps, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * w, ps, hkv, d)
    table = perm.to(torch.int32).reshape(b, w).contiguous()
    return dict(b=b, hq=hq, hkv=hkv, g=g, m=m, d=d, ps=ps, w=w, q=q, k=k,
                v=v, k_pages=k_pages, v_pages=v_pages, table=table)


def granite_paged_data(torch, gen):
    """A granite-3-8b decode step: 8 slots, 32 q over 8 kv heads, head dim
    128, a 2048-token cache, a 1024-page pool (page_size 16, W 128)."""
    return paged_data(torch, gen, 8, 32, 8, 2048, 128)


def gemma2_paged_data(torch, gen, m=8192):
    """A gemma2-9b decode step: 4 slots, 16 q over 8 kv heads, head dim
    256, a global layer's 8192-token cache (or a local layer's ring of
    4096) and its pool (page_size 16)."""
    return paged_data(torch, gen, 4, 16, 8, m, 256)


def with_sentinels(table, kvl, ps, n_pages):
    """``table`` with the entries past each row's kv_len set to the
    sentinel ``n_pages``."""
    t = table.clone()
    for i, n in enumerate(kvl):
        t[i, -(-n // ps):] = n_pages
    return t


def quantized(torch, pools, kv_dtype):
    """Per pool: (codes, fp16 scales, the fp32 pool they decode to),
    through the port's ``quantize_kv`` (one scale per trailing vector)."""
    from repro_torch.model.attention import (
        dequantize_kv, kv_quant_dtype, quantize_kv,
    )

    qdt = kv_quant_dtype(kv_dtype)
    out = []
    for x in pools:
        codes, scales = quantize_kv(x, qdt)
        out.append((codes, scales, dequantize_kv(codes, scales)))
    return out

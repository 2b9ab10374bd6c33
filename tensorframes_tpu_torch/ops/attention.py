"""Paged decode attention: the gather read, the ragged kernel, its plain form.

The port of the serving half of ``tensorframes_tpu/ops/attention.py``:

- :func:`paged_attention` — the materialized gather read (the oracle);
- :func:`ragged_paged_attention` — the fused read. On a CUDA tensor it
  launches the hand-written kernel ``ops/csrc/ragged_paged_attention.cu``
  (which replaces the Pallas ``_ragged_paged_kernel``); on a CPU tensor it
  runs :func:`ragged_paged_attention_reference`, the kernel's arithmetic
  in plain torch. Its ``launches`` attribute counts kernel launches.

Layouts are the reference's: ``q`` ``[S, n_kv, group, hd]``, page pools
``[pool_pages, page_size, n_kv, hd]``, ``page_table`` ``[S, max_pages]``
int32, ``lengths`` ``[S]`` int32 (valid positions INCLUDING the token
just written).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "paged_attention",
    "ragged_paged_attention",
    "ragged_paged_attention_reference",
]

_NEG_BIG = -0.7 * float(np.finfo(np.float32).max)  # mask value; exp() == 0
#: the online softmax runs in base 2: scores are pre-scaled by log2(e)
#: and the exponentials are exp2, exactly as ``online_block_update``
_LOG2E = float(np.log2(np.e))

_SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_SUPPORTED_HEAD_DIMS = (64, 128)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _check_paged_inputs(q, k_pages, v_pages, page_table, lengths):
    """Shared validation for the paged decode reads (gather and fused).
    A float ``lengths`` or an int64 table would not fail — it would
    silently miscompute — so wrong shapes and dtypes raise here."""
    if q.dim() != 4:
        raise ValueError(
            f"q must be [slots, n_kv, group, head_dim]; got shape "
            f"{tuple(q.shape)}"
        )
    slots, n_kv, _, hd = q.shape
    for name, arr in (("k_pages", k_pages), ("v_pages", v_pages)):
        if arr.dim() != 4:
            raise ValueError(
                f"{name} must be [pool_pages, page_size, n_kv, head_dim]; "
                f"got shape {tuple(arr.shape)}"
            )
    if k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages and v_pages must share a shape; got "
            f"{tuple(k_pages.shape)} vs {tuple(v_pages.shape)}"
        )
    if k_pages.shape[2] != n_kv or k_pages.shape[3] != hd:
        raise ValueError(
            f"page pool holds (n_kv={k_pages.shape[2]}, "
            f"head_dim={k_pages.shape[3]}) but q asks for "
            f"(n_kv={n_kv}, head_dim={hd})"
        )
    if page_table.dim() != 2 or page_table.shape[0] != slots:
        raise ValueError(
            f"page_table must be [slots={slots}, max_pages]; got shape "
            f"{tuple(page_table.shape)}"
        )
    if tuple(lengths.shape) != (slots,):
        raise ValueError(
            f"lengths must be [slots={slots}]; got shape "
            f"{tuple(lengths.shape)}"
        )
    for name, arr in (("page_table", page_table), ("lengths", lengths)):
        if arr.dtype != torch.int32:
            raise ValueError(
                f"{name} must be int32 (got {_dtype_name(arr.dtype)}): the "
                f"position mask and the page gather consume it as-is, and a "
                f"wrong dtype miscomputes silently — cast with "
                f".to(torch.int32)"
            )


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """Single-token attention over a paged KV cache by materialized gather:
    every slot reads ``max_pages * page_size`` positions and masks
    ``t >= lengths`` before one softmax. Returns ``[S, n_kv, group, hd]``."""
    _check_paged_inputs(q, k_pages, v_pages, page_table, lengths)
    slots, n_kv, group, hd = q.shape
    t = page_table.shape[1] * k_pages.shape[1]
    ptab = page_table.long()
    kg = k_pages[ptab].reshape(slots, t, n_kv, hd)
    vg = v_pages[ptab].reshape(slots, t, n_kv, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bkgd,btkd->bkgt", q, kg) * scale
    visible = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(visible[:, None, None, :], s, _NEG_BIG)
    return torch.einsum("bkgt,btkd->bkgd", torch.softmax(s, dim=-1), vg)


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table, lengths):
    """The kernel's arithmetic in plain torch: walk the live pages, one
    page index at a time for every slot at once, folding each
    ``[page_size]`` key tile into an f32 online softmax (base 2, as
    ``online_block_update``) and finalizing ``acc / max(l, 1e-30)``. A
    slot whose length ends before page ``p`` is fully masked there, which
    leaves its state exactly unchanged."""
    _check_paged_inputs(q, k_pages, v_pages, page_table, lengths)
    slots, n_kv, group, hd = q.shape
    ps = k_pages.shape[1]
    dev = q.device
    qk_scale = (1.0 / math.sqrt(hd)) * _LOG2E
    lowp = q.dtype == torch.bfloat16
    qf = q.to(torch.float32)
    m = torch.full((slots, n_kv, group, 1), _NEG_BIG, device=dev)
    l = torch.zeros((slots, n_kv, group, 1), device=dev)
    acc = torch.zeros((slots, n_kv, group, hd), device=dev)
    lens = lengths.long()
    live = int(((lens.max() + ps - 1) // ps).item()) if slots else 0
    live = min(live, page_table.shape[1])
    offs = torch.arange(ps, device=dev)
    for p in range(live):
        page = page_table[:, p].long()
        kj = k_pages[page].to(torch.float32)  # [S, ps, n_kv, hd]
        vj = v_pages[page].to(torch.float32)
        s = torch.einsum("skgd,stkd->skgt", qf, kj) * qk_scale
        mask = (p * ps + offs)[None, :] < lens[:, None]  # [S, ps]
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, _NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        pr = torch.where(mask, torch.exp2(s - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = alpha * l + pr.sum(dim=-1, keepdim=True)
        if lowp:
            # the probabilities enter the PV product in the value dtype
            pr = pr.to(torch.bfloat16).to(torch.float32)
        acc = alpha * acc + torch.einsum("skgt,stkd->skgd", pr, vj)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def ragged_paged_attention(q, k_pages, v_pages, page_table, lengths):
    """Fused single-token paged-attention read; same contract as
    :func:`paged_attention` and agrees with it to float tolerance.

    Tensors on the CPU run :func:`ragged_paged_attention_reference`.
    Tensors on a CUDA device launch the hand-written kernel (f32 or bf16,
    ``head_dim`` 64 or 128, every input contiguous and on one device) and
    count the launch in ``ragged_paged_attention.launches``; anything the
    kernel does not take raises. There is no fallback between the two."""
    _check_paged_inputs(q, k_pages, v_pages, page_table, lengths)
    devices = {t.device for t in (q, k_pages, v_pages, page_table, lengths)}
    if len(devices) != 1:
        raise ValueError(
            f"ragged_paged_attention inputs must share one device; got "
            f"{sorted(str(d) for d in devices)}"
        )
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, lengths
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"ragged_paged_attention runs on CUDA or CPU tensors; got "
            f"{q.device}"
        )
    if q.dtype not in _SUPPORTED_DTYPES or not (
        q.dtype == k_pages.dtype == v_pages.dtype
    ):
        raise ValueError(
            f"ragged_paged_attention kernel takes float32 or bfloat16 q and "
            f"pages of one dtype; got q {_dtype_name(q.dtype)}, pages "
            f"{_dtype_name(k_pages.dtype)}/{_dtype_name(v_pages.dtype)}"
        )
    hd = q.shape[3]
    if hd not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(
            f"ragged_paged_attention kernel supports head_dim "
            f"{_SUPPORTED_HEAD_DIMS}; got {hd}"
        )
    for name, t in (
        ("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
        ("page_table", page_table), ("lengths", lengths),
    ):
        if not t.is_contiguous():
            raise ValueError(f"ragged_paged_attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    from ._kernels import launch_ragged_paged_attention

    launch_ragged_paged_attention(
        q, k_pages, v_pages, page_table, lengths, out,
        (1.0 / math.sqrt(hd)) * _LOG2E,
    )
    ragged_paged_attention.launches += 1
    return out


#: kernel launches since the last reset (the CPU plain path never counts)
ragged_paged_attention.launches = 0

"""Decoder-only transformer LM: the serving surface of the JAX model.

The port of ``tensorframes_tpu/models/transformer.py`` for the serving
slice: learned positional embeddings, pre-LN blocks (grouped-query
attention -> residual, tanh-GELU MLP -> residual), final LN, tied output
head. Weights keep the JAX layout (``x @ W`` with ``W`` of shape
``[in, out]``) so a JAX params dict maps one to one onto
:class:`TransformerLM` (:func:`params_from_numpy`).

- :func:`init_transformer` is a numpy copy of the reference initializer
  with the same rng draw order, so a seed gives the same weights;
- :func:`transformer_step` / :func:`transformer_prefill` are the decode
  and prompt block walks the serving engine runs;
- :func:`transformer_logits` is the dense full forward in float32, the
  reference the engine's logits are checked against.

Dense MLP blocks only: mixture-of-experts blocks wait for a later slice.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.config import resolve_device

__all__ = [
    "init_transformer",
    "params_from_numpy",
    "TransformerLM",
    "filter_logits",
    "transformer_logits",
    "transformer_prefill",
    "transformer_step",
]

Params = Dict[str, Any]

#: attention mask fill (``ops/attention.py::_NEG_BIG`` in both packages)
_NEG_BIG = -0.7 * float(np.finfo(np.float32).max)


def init_transformer(
    seed: int,
    vocab: int,
    d_model: int = 64,
    n_heads: int = 4,
    n_layers: int = 2,
    max_len: int = 128,
    d_ff: Optional[int] = None,
    moe_experts: Optional[int] = None,
    n_kv_heads: Optional[int] = None,
    dtype=np.float32,
) -> Params:
    """Numpy params dict, draw for draw the reference initializer's
    (``tensorframes_tpu/models/transformer.py::init_transformer``)."""
    if moe_experts is not None:
        raise NotImplementedError(
            "mixture-of-experts blocks are not ported yet; dense MLP only"
        )
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} must divide by n_heads {n_heads}")
    n_kv_heads = n_heads if n_kv_heads is None else n_kv_heads
    if n_kv_heads < 1 or n_heads % n_kv_heads:
        raise ValueError(
            f"n_heads {n_heads} must divide by n_kv_heads {n_kv_heads} "
            f"(>= 1)"
        )
    d_ff = d_ff or 4 * d_model
    kv_d = (d_model // n_heads) * n_kv_heads
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out):
        return (rng.normal(0, fan_in**-0.5, (fan_in, fan_out))).astype(dtype)

    params: Params = {
        "embed": (rng.normal(0, 0.02, (vocab, d_model))).astype(dtype),
        "pos": (rng.normal(0, 0.02, (max_len, d_model))).astype(dtype),
        "blocks": [],
        "ln_f": {"g": np.ones(d_model, dtype), "b": np.zeros(d_model, dtype)},
        "n_heads": n_heads,
    }
    for _ in range(n_layers):
        params["blocks"].append(
            {
                "ln1": {"g": np.ones(d_model, dtype), "b": np.zeros(d_model, dtype)},
                "qkv": dense(d_model, d_model + 2 * kv_d),
                "proj": dense(d_model, d_model),
                "ln2": {"g": np.ones(d_model, dtype), "b": np.zeros(d_model, dtype)},
                "up": dense(d_model, d_ff),
                "down": dense(d_ff, d_model),
            }
        )
    return params


def _param(a, device, dtype=None) -> nn.Parameter:
    t = torch.as_tensor(np.asarray(a), device=device)
    if dtype is not None:
        t = t.to(dtype)
    return nn.Parameter(t.contiguous(), requires_grad=False)


class _Block(nn.Module):
    def __init__(self, block: Params, device, dtype=None):
        super().__init__()
        if "moe" in block:
            raise NotImplementedError(
                "mixture-of-experts blocks are not ported yet; dense MLP only"
            )
        self.ln1_g = _param(block["ln1"]["g"], device, dtype)
        self.ln1_b = _param(block["ln1"]["b"], device, dtype)
        self.qkv = _param(block["qkv"], device, dtype)
        self.proj = _param(block["proj"], device, dtype)
        self.ln2_g = _param(block["ln2"]["g"], device, dtype)
        self.ln2_b = _param(block["ln2"]["b"], device, dtype)
        self.up = _param(block["up"], device, dtype)
        self.down = _param(block["down"], device, dtype)


class TransformerLM(nn.Module):
    """The LM's weights as an ``nn.Module`` in the JAX layout; built with
    :func:`params_from_numpy`. ``forward(tokens)`` is the
    dense full forward (:func:`transformer_logits`)."""

    def __init__(self, params: Params, device="cuda", dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.n_heads = int(params["n_heads"])
        self.embed = _param(params["embed"], device, dtype)
        self.pos = _param(params["pos"], device, dtype)
        self.blocks = nn.ModuleList(
            [_Block(b, device, dtype) for b in params["blocks"]]
        )
        self.ln_f_g = _param(params["ln_f"]["g"], device, dtype)
        self.ln_f_b = _param(params["ln_f"]["b"], device, dtype)

    @property
    def d_model(self) -> int:
        return int(self.embed.shape[1])

    @property
    def vocab(self) -> int:
        return int(self.embed.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.pos.shape[0])

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_kv_heads(self) -> int:
        return _kv_heads(self.blocks[0], self.d_model, self.n_heads)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer_logits(self, tokens)


def params_from_numpy(jax_params: Params, device="cuda", dtype=None) -> TransformerLM:
    """Carry a JAX params dict (numpy or jax arrays, ``n_heads`` entry
    included) across into a :class:`TransformerLM` on ``device``."""
    return TransformerLM(jax_params, device=device, dtype=dtype)


def _ln(x, g, b):
    """LayerNorm with the population variance and eps inside the sqrt,
    as ``jnp`` computes it."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def _kv_heads(block, d_model: int, n_heads: int) -> int:
    """GQA group count from the qkv weight's shape: its columns are
    ``d + 2 * n_kv * head_dim``."""
    kv_d = (int(block.qkv.shape[1]) - d_model) // 2
    return kv_d // (d_model // n_heads)


def _mlp(block, h):
    hx = _ln(h, block.ln2_g, block.ln2_b)
    return h + F.gelu(hx @ block.up, approximate="tanh") @ block.down


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p=1.0):
    """Top-k / nucleus (top-p) filtering, ``[B, V] -> [B, V]`` with
    masked-out entries at a large negative. ``top_p`` may be a tensor
    (broadcast against ``[B, 1]``; always applied, as a traced value is
    in the reference) or a number (``>= 1.0`` is off). The first token
    always survives, so a tiny top_p degrades to greedy."""
    neg = float(np.finfo(np.float32).min) * 0.7
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        if k < logits.shape[-1]:
            kth = torch.topk(logits, k, dim=-1).values[..., -1:]
            logits = torch.where(logits < kth, neg, logits)
    if top_p is not None and not (
        isinstance(top_p, (int, float)) and top_p >= 1.0
    ):
        sl = torch.sort(logits, dim=-1, descending=True).values
        ps = torch.softmax(sl, dim=-1)
        css = torch.cumsum(ps, dim=-1)
        # token j (sorted order) kept iff the mass BEFORE it is < top_p
        keep = (css - ps) < top_p
        k_eff = keep.sum(dim=-1, keepdim=True)  # >= 1 by construction
        thresh = torch.gather(sl, -1, k_eff - 1)
        logits = torch.where(logits < thresh, neg, logits)
    return logits


def transformer_step(
    model: TransformerLM,
    tok: torch.Tensor,
    positions: torch.Tensor,
    attend: Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """One decoder step for a batch of single tokens. ``tok`` / ``positions``
    ``[B]`` int; attention is delegated to ``attend(li, q, k, v)`` which
    gets layer ``li``'s query ``[B, n_kv, group, hd]`` and this step's k/v
    ``[B, n_kv, hd]``, stores them in the caller's cache, and returns the
    pre-``proj`` context ``[B, d_model]``. Returns logits ``[B, vocab]``."""
    n_heads = model.n_heads
    d_model = model.d_model
    hd = d_model // n_heads
    bsz = tok.shape[0]
    h = model.embed[tok] + model.pos[positions]
    for li, block in enumerate(model.blocks):
        n_kv = _kv_heads(block, d_model, n_heads)
        group = n_heads // n_kv
        kv_d = n_kv * hd
        qkv = _ln(h, block.ln1_g, block.ln1_b) @ block.qkv
        q, k, v = torch.split(qkv, [d_model, kv_d, kv_d], dim=-1)
        att = attend(
            li,
            q.reshape(bsz, n_kv, group, hd),
            k.reshape(bsz, n_kv, hd),
            v.reshape(bsz, n_kv, hd),
        )
        h = h + att @ block.proj
        h = _mlp(block, h)
    return _ln(h, model.ln_f_g, model.ln_f_b) @ model.embed.T


def transformer_prefill(model: TransformerLM, tokens: torch.Tensor):
    """Batched causal prompt pass that also returns the per-layer k/v:
    ``tokens`` ``[B, P]`` -> ``(logits [B, P, vocab], k [L, B, n_kv, P, hd],
    v [L, B, n_kv, P, hd])`` — the same grouped-query einsum family as the
    reference's prefill."""
    bsz, plen = tokens.shape
    n_heads = model.n_heads
    d_model = model.d_model
    hd = d_model // n_heads
    scale = 1.0 / math.sqrt(hd)
    neg = float(np.finfo(np.float32).min) * 0.7
    ar = torch.arange(plen, device=tokens.device)
    causal = ar[:, None] >= ar[None, :]  # [P(q), P(k)]
    h = model.embed[tokens] + model.pos[:plen][None]
    ks, vs = [], []
    for block in model.blocks:
        n_kv = _kv_heads(block, d_model, n_heads)
        group = n_heads // n_kv
        kv_d = n_kv * hd
        qkv = _ln(h, block.ln1_g, block.ln1_b) @ block.qkv
        q, k, v = torch.split(qkv, [d_model, kv_d, kv_d], dim=-1)
        kc = k.reshape(bsz, plen, n_kv, hd).transpose(1, 2)  # [B, n_kv, P, hd]
        vc = v.reshape(bsz, plen, n_kv, hd).transpose(1, 2)
        ks.append(kc)
        vs.append(vc)
        qh = q.reshape(bsz, plen, n_kv, group, hd).permute(0, 2, 3, 1, 4)
        s = torch.einsum("bkgqd,bktd->bkgqt", qh, kc) * scale
        s = torch.where(causal, s, neg)
        att = torch.einsum("bkgqt,bktd->bkgqd", torch.softmax(s, dim=-1), vc)
        att = att.permute(0, 3, 1, 2, 4).reshape(bsz, plen, d_model)
        h = h + att @ block.proj
        h = _mlp(block, h)
    logits = _ln(h, model.ln_f_g, model.ln_f_b) @ model.embed.T
    return logits, torch.stack(ks), torch.stack(vs)


def transformer_logits(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """Dense causal full forward in float32, ``[B, L] -> [B, L, vocab]``:
    the reference's ``transformer_logits`` with ``attn_impl="reference"``
    (k/v repeated to every query head, one softmax over the masked
    scores). Independent of the serving walks, so it checks them."""
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    bsz, length = tokens.shape
    n_heads = model.n_heads
    d = model.d_model
    hd = d // n_heads
    scale = 1.0 / math.sqrt(hd)
    qi = torch.arange(length, device=tokens.device)
    valid = qi[:, None] >= qi[None, :]
    x = f32(model.embed)[tokens] + f32(model.pos)[:length][None]
    for block in model.blocks:
        n_kv = _kv_heads(block, d, n_heads)
        kv_d = n_kv * hd
        qkv = _ln(x, f32(block.ln1_g), f32(block.ln1_b)) @ f32(block.qkv)
        q, k, v = torch.split(qkv, [d, kv_d, kv_d], dim=-1)

        def heads(t, n):  # [B, L, n*hd] -> [B, n, L, hd]
            return t.reshape(bsz, length, n, hd).transpose(1, 2)

        q, k, v = heads(q, n_heads), heads(k, n_kv), heads(v, n_kv)
        if n_kv != n_heads:
            k = k.repeat_interleave(n_heads // n_kv, dim=1)
            v = v.repeat_interleave(n_heads // n_kv, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
        s = torch.where(valid, s, _NEG_BIG)
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
        o = o.transpose(1, 2).reshape(bsz, length, d)
        x = x + o @ f32(block.proj)
        hx = _ln(x, f32(block.ln2_g), f32(block.ln2_b))
        x = x + F.gelu(hx @ f32(block.up), approximate="tanh") @ f32(block.down)
    x = _ln(x, f32(model.ln_f_g), f32(model.ln_f_b))
    return x @ f32(model.embed).T

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as a check of the card
    python3 chip_smoke.py --phases env,kernel   # a subset, for bring-up
    python3 chip_smoke.py --phases env,slice,profile   # decode-step profile

Phases, in order (each prints one JSON line; any failure raises and the
script exits non-zero without a result line):

1. ``env``: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, TF32 off, and the build of the CUDA kernel from the
   source in this checkout.
2. ``kernel``: each kernel against its plain PyTorch version on the card
   at the serving slice's shapes (f32 within atol/rtol 1e-5; bf16 within
   atol 1e-3 + rtol 8e-3, one bf16 rounding of the output), with
   CUDA-event times for the kernel, the plain version and one PyTorch
   library call computing the same function, and the kernel's bound.
3. ``slice``: the full-width GQA transformer (vocab 8192, d_model 512,
   8 heads over 2 KV heads, 8 layers, d_ff 2048, max_len 1057; random
   weights from seed 0) behind ``GenerationEngine(device="cuda")`` serves
   16 requests (prompts of 32..960 tokens, 64 new tokens each, half
   greedy and half seeded sampling). The decode read must go through the
   kernel (launches == decode steps x layers), and two greedy streams'
   per-step logits must agree with the dense float32 forward.
4. ``server``: ``ScoringServer(engine=...)`` on localhost answers three
   ``POST /generate``, ``GET /healthz`` and ``GET /metrics``.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PHASES = ("env", "kernel", "slice", "profile", "server")
#: what a run with no arguments does (the profile is opt-in)
DEFAULT_PHASES = ("env", "kernel", "slice", "server")

# the serving slice: benchmarks/decode_bench.py's GQA transformer
MODEL = dict(vocab=8192, d_model=512, n_heads=8, n_kv_heads=2, n_layers=8,
             d_ff=2048, max_len=1057)
MAX_SLOTS = 16
PAGE_SIZE = 16
#: (atol, rtol) per input dtype: f32 to rounding of the sum order; bf16
#: to one rounding of the bf16 output (2**-7 relative) plus a small floor
TOLS = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 8e-3)}
#: H100 SXM: HBM rate and dense peaks (NVIDIA data sheet)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, flush=None, warmup: int = 3) -> float:
    """Mean milliseconds per call by CUDA events over ``iters`` calls.
    With ``flush``, each call is preceded by an L2 flush and the flush's
    own time (measured alone) is subtracted: the caller's decode step
    finds the KV pool cold, not L2-resident."""
    import torch

    def run(f):
        for _ in range(warmup):
            f()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            f()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    if flush is None:
        return run(fn)

    def both():
        flush()
        fn()

    return max(0.0, run(both) - run(flush))


# -- phase 1 -------------------------------------------------------------


def phase_env(state) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tensorframes_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    rec = _kernels.build()
    build_s = time.perf_counter() - t0
    ptx = [l for l in rec["ptxas"].splitlines() if "registers" in l or "spill" in l]
    print("ptxas: " + " | ".join(x.strip() for x in ptx), file=sys.stderr)
    state["gpu"] = gpu_line()
    print(state["gpu"], flush=True)
    emit({
        "phase": "env",
        "gpu": state["gpu"],
        "device_name": torch.cuda.get_device_name(0),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernel_build_s": round(build_s, 3),
        "kernels_built": ["ragged_paged_attention"],
    })


# -- phase 2 -------------------------------------------------------------


def _paged_inputs(gen, dtype):
    """Slice-shaped decode-read inputs made on the card from ``gen``:
    16 slots over 1072 pages of 16 positions, ragged lengths over 1..1057
    including exact page boundaries, and one idle slot whose table is
    all trash."""
    import torch

    n_kv, hd = MODEL["n_kv_heads"], MODEL["d_model"] // MODEL["n_heads"]
    group = MODEL["n_heads"] // n_kv
    mp = math.ceil(MODEL["max_len"] / PAGE_SIZE)
    num_pages = MAX_SLOTS * mp
    lengths = [1057, 1, 16, 17, 32, 100, 256, 511, 512, 700, 960, 1024,
               1040, 1056, 33, 1]
    idle = MAX_SLOTS - 1
    perm = torch.randperm(num_pages, generator=gen, device="cuda").cpu().tolist()
    table = torch.full((MAX_SLOTS, mp), num_pages, dtype=torch.int32)
    used = 0
    for s, n in enumerate(lengths):
        if s == idle:
            continue
        k = math.ceil(n / PAGE_SIZE)
        table[s, :k] = torch.tensor(perm[used:used + k], dtype=torch.int32)
        used += k
    shape = (num_pages + 1, PAGE_SIZE, n_kv, hd)
    kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q = torch.randn((MAX_SLOTS, n_kv, group, hd), generator=gen, device="cuda")
    return (q.to(dtype), kp, vp, table.cuda(), torch.tensor(
        lengths, dtype=torch.int32, device="cuda"))


def _library_read(q, kp, vp, table, lengths):
    """The same function through one PyTorch library call: the page
    gather and ``scaled_dot_product_attention`` (the group's query rows
    share their kv head, so each (slot, kv head) is one attention)."""
    import torch
    import torch.nn.functional as F

    s, n_kv, group, hd = q.shape
    t = table.shape[1] * kp.shape[1]
    kg = kp[table.long()].reshape(s, t, n_kv, hd).transpose(1, 2)
    vg = vp[table.long()].reshape(s, t, n_kv, hd).transpose(1, 2)
    mask = (torch.arange(t, device=q.device)[None, :] < lengths[:, None])
    return F.scaled_dot_product_attention(q, kg, vg, attn_mask=mask[:, None, None, :])


def _kernel_range_check(gen) -> dict:
    """The rest of the kernel's supported range, beyond the slice's shapes
    (head_dim 128, wider groups, larger and smaller pages, MHA and MQA;
    the last shape needs more than 48 KB of shared memory), against the
    plain version; and a head_dim it does not take must raise. Returns
    the max abs error per (dtype, shape)."""
    import torch

    from tensorframes_tpu_torch.ops import attention as A

    errs = {}
    for n_kv, group, hd, ps in ((4, 1, 128, 32), (1, 16, 128, 8), (2, 8, 128, 128)):
        pool, mp = 80, 12
        lengths = [1, ps, ps + 1, 3 * ps - 1, mp * ps, 5]
        s = len(lengths)
        table = torch.randperm(pool, generator=gen, device="cuda")[: s * mp]
        table = table.reshape(s, mp).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            atol, rtol = TOLS[str(dtype)[6:]]
            shape = (pool + 1, ps, n_kv, hd)
            args = (
                torch.randn((s, n_kv, group, hd), generator=gen, device="cuda").to(dtype),
                torch.randn(shape, generator=gen, device="cuda").to(dtype),
                torch.randn(shape, generator=gen, device="cuda").to(dtype),
                table, lens,
            )
            out = A.ragged_paged_attention(*args).float()
            ref = A.ragged_paged_attention_reference(*args).float()
            err = (out - ref).abs().max().item()
            key = f"{str(dtype)[6:]}:kv{n_kv}g{group}hd{hd}ps{ps}"
            errs[key] = err
            if (not torch.allclose(out, ref, atol=atol, rtol=rtol)
                    or not torch.isfinite(out).all()):
                fail(f"ragged_paged_attention {key}: max abs err {err} beyond "
                     f"atol {atol} rtol {rtol}")
    q = torch.zeros((2, 1, 1, 96), device="cuda")
    pages = torch.zeros((3, 4, 1, 96), device="cuda")
    try:
        A.ragged_paged_attention(
            q, pages, pages, torch.zeros((2, 1), dtype=torch.int32, device="cuda"),
            torch.ones(2, dtype=torch.int32, device="cuda"))
    except ValueError:
        pass
    else:
        fail("ragged_paged_attention accepted head_dim 96")
    return errs


def phase_kernel(state) -> None:
    import torch

    from tensorframes_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        atol, rtol = TOLS[name]
        args = _paged_inputs(gen, dtype)
        q, kp, vp, table, lengths = args
        out = A.ragged_paged_attention(*args)
        torch.cuda.synchronize()
        ref = A.ragged_paged_attention_reference(*args)
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out.float()).all():
            fail(f"kernel output not finite ({dtype})")
        if not torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol):
            fail(f"ragged_paged_attention {name}: max abs err {err} beyond "
                 f"atol {atol} rtol {rtol}")
        if dtype == torch.float32:
            # the plain page walk itself against the one-shot gather oracle
            gerr = (ref - A.paged_attention(*args)).abs().max().item()
            if gerr > 1e-5:
                fail(f"plain page walk disagrees with the gather: {gerr}")
        elt = torch.tensor([], dtype=dtype).element_size()
        n_kv, hd = q.shape[1], q.shape[3]
        group = q.shape[2]
        live = int(lengths.long().sum().item())
        live_pages = int(((lengths.long() + PAGE_SIZE - 1) // PAGE_SIZE).sum().item())
        nbytes = (live * n_kv * hd * elt * 2            # live K and V rows
                  + 2 * q.numel() * elt                 # q in, out
                  + lengths.numel() * 4 + live_pages * 4)  # lengths, table rows
        flops = 4 * live * n_kv * group * hd
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        res[name] = {
            "max_abs_err": err,
            "ms": cuda_ms(lambda: A.ragged_paged_attention(*args), 50, flush),
            "plain_ms": cuda_ms(
                lambda: A.ragged_paged_attention_reference(*args), 5, flush, 1),
            "library_ms": cuda_ms(lambda: _library_read(*args), 20, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "flops": flops,
        }
        # the library call computes the same function: hold it too
        lerr = (_library_read(*args).float() - ref.float()).abs().max().item()
        res[name]["library_max_abs_err"] = lerr
    del flush_buf
    res["range_max_abs_err"] = _kernel_range_check(gen)
    state["kernel"] = res
    emit({"phase": "kernel", "name": "ragged_paged_attention",
          "gpu": state.get("gpu"), **res})


# -- phase 3 -------------------------------------------------------------


def phase_slice(state) -> None:
    import numpy as np
    import torch

    from tensorframes_tpu_torch.models import (
        init_transformer,
        params_from_numpy,
        transformer_logits,
    )
    from tensorframes_tpu_torch.ops import ragged_paged_attention
    from tensorframes_tpu_torch.serve import GenerationEngine

    vocab = MODEL["vocab"]
    params = init_transformer(
        0, vocab, d_model=MODEL["d_model"], n_heads=MODEL["n_heads"],
        n_layers=MODEL["n_layers"], max_len=MODEL["max_len"],
        d_ff=MODEL["d_ff"], n_kv_heads=MODEL["n_kv_heads"],
    )
    model = params_from_numpy(params, device="cuda")
    eng = GenerationEngine(model, max_slots=MAX_SLOTS, page_size=PAGE_SIZE,
                           device="cuda")
    state["engine"] = eng
    if eng.attention_impl != "fused":
        fail(f"engine attention_impl is {eng.attention_impl!r}, not 'fused'")
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator): not part of the counted run
    eng.generate([rng.integers(0, vocab, 40).tolist()], 4)
    torch.cuda.synchronize()

    lens = np.linspace(32, 960, MAX_SLOTS).astype(int)
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in lens]
    # the two greedy requests checked against the dense forward: the
    # shortest and the longest greedy prompts
    greedy_idx = [i for i in range(MAX_SLOTS) if i % 2 == 0]
    checked = {greedy_idx[0], greedy_idx[-1]}
    recorded = {}

    ragged_paged_attention.launches = 0
    eng.decode_steps = 0
    eng.decode_seconds = 0.0
    t0 = time.perf_counter()
    handles = []
    for i, p in enumerate(prompts):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_p=0.95, seed=1000 + i)
        handles.append(eng.submit(p, 64, **kw))
    checked_ids = {handles[i].request_id: i for i in checked}

    def hook(rid, pos, row):
        if rid in checked_ids:
            recorded.setdefault(rid, []).append((pos, row.float().cpu()))

    eng.logits_hook = hook
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_paged_attention.launches
    eng.logits_hook = None
    outs = [h.result(timeout=0) for h in handles]

    n_layers = MODEL["n_layers"]
    if eng.decode_steps < 1 or launches != eng.decode_steps * n_layers:
        fail(f"kernel launches {launches} != decode steps {eng.decode_steps} "
             f"x {n_layers} layers")
    for o in outs:
        if o.shape != (64,) or o.min() < 0 or o.max() >= vocab:
            fail(f"bad generation {o.shape} range [{o.min()}, {o.max()}]")

    max_err = 0.0
    worst_margin = 0.0
    for rid, i in checked_ids.items():
        seq = np.concatenate([np.asarray(prompts[i]), outs[i]])
        with torch.no_grad():
            ref = transformer_logits(
                model, torch.as_tensor(seq[None], device="cuda"))[0].cpu()
        rows = recorded.get(rid, [])
        if len(rows) != 64:
            fail(f"request {rid}: {len(rows)} logits rows recorded, not 64")
        for pos, row in rows:
            r = ref[pos]
            max_err = max(max_err, (row - r).abs().max().item())
            tok = int(seq[pos + 1])
            margin = (r.max() - r[tok]).item()
            worst_margin = max(worst_margin, margin)
            if margin > 1e-4:
                fail(f"request {rid} pos {pos}: greedy token {tok} is "
                     f"{margin} below the reference argmax")
    if not max_err <= 1e-3:
        fail(f"engine logits differ from the dense forward by {max_err}")

    ttft = sorted(h.timings["ttft_s"] for h in handles)
    gen_tokens = sum(len(o) for o in outs)
    state["launches"] = launches
    state["slice"] = {
        "requests": len(outs),
        "tokens_generated": gen_tokens,
        "wall_s": wall,
        "tokens_per_s": gen_tokens / wall,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "ttft_max_s": ttft[-1],
        "decode_steps": eng.decode_steps,
        "decode_step_ms": 1e3 * eng.decode_seconds / eng.decode_steps,
        "kernel_launches": launches,
        "logits_max_abs_err": max_err,
        "greedy_worst_margin": worst_margin,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit({"phase": "slice", "gpu": state.get("gpu"), **state["slice"]})


# -- optional: decode-step profile ---------------------------------------


def phase_profile(state) -> None:
    """Where a decode step's time goes: ``torch.profiler`` over 16 steps
    of a full 16-slot batch (half greedy, half sampled). Prints device
    time by kernel and the device's busy share of the window."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng = state["engine"]
    rng = np.random.default_rng(2)
    for i, n in enumerate(np.linspace(32, 960, MAX_SLOTS).astype(int)):
        kw = {} if i % 2 == 0 else dict(temperature=0.8, top_p=0.95, seed=i)
        eng.submit(rng.integers(0, MODEL["vocab"], int(n)).tolist(), 40, **kw)
    eng.step()  # admits and prefills all 16, then one decode step
    eng.step()
    torch.cuda.synchronize()
    steps = 16
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.run_until_idle()
    rows = []
    dev_total = 0.0
    for evt in prof.key_averages():
        dt = getattr(evt, "self_device_time_total", 0.0) or 0.0
        if dt <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(evt, "is_user_annotation", False) or evt.key.startswith("serve."):
            continue  # the engine's span ranges, not kernels
        dev_total += dt
        rows.append((dt, evt.key, evt.count))
    rows.sort(reverse=True)
    emit({
        "phase": "profile", "gpu": state.get("gpu"), "steps": steps,
        "step_ms": 1e3 * wall / steps,
        "device_ms_per_step": dev_total / 1e3 / steps,
        "device_busy_share": dev_total / 1e6 / wall,
        "kernels_per_step": sum(r[2] for r in rows) / steps,
        "top": [{"kernel": k[:90], "ms_per_step": dt / 1e3 / steps,
                 "calls_per_step": c / steps} for dt, k, c in rows[:15]],
    })


# -- phase 4 -------------------------------------------------------------


def phase_server(state) -> None:
    import urllib.request

    import numpy as np

    from tensorframes_tpu_torch.interop import ScoringServer

    eng = state["engine"]
    rng = np.random.default_rng(1)
    srv = ScoringServer(engine=eng)
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        answers = []
        for i in range(3):
            body = json.dumps({
                "prompt": rng.integers(0, MODEL["vocab"], 20 + 10 * i).tolist(),
                "max_new_tokens": 8, "temperature": 0.8 if i else 0.0,
                "top_p": 0.95, "seed": i,
            }).encode()
            req = urllib.request.Request(
                base + "/generate", data=body, method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                if r.status != 200:
                    fail(f"/generate answered {r.status}")
                out = json.loads(r.read())
            if len(out["tokens"]) != 8:
                fail(f"/generate returned {len(out['tokens'])} tokens, not 8")
            answers.append(out["tokens"])
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
            if r.status != 200 or not health["healthy"]:
                fail(f"/healthz answered {r.status}: {health}")
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            scrape = r.read().decode()
        series = sorted({
            line.split("{")[0].split(" ")[0]
            for line in scrape.splitlines()
            if line.startswith("tft_serve_")
        })
        for need in ("tft_serve_tokens_total", "tft_serve_requests_total",
                     "tft_serve_ttft_seconds_count"):
            if need not in series:
                fail(f"/metrics lacks {need}")
    finally:
        srv.stop()
    emit({"phase": "server", "generate_ok": len(answers), "healthz": 200,
          "serve_series": len(series)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(DEFAULT_PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p!r}")
    if not (REPO / "tensorframes_tpu_torch").is_dir():
        print("chip_smoke.py: the tensorframes_tpu_torch package is not next "
              "to this script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    state = {}
    runners = {"env": phase_env, "kernel": phase_kernel,
               "slice": phase_slice, "profile": phase_profile,
               "server": phase_server}
    for p in PHASES:
        if p in phases:
            t0 = time.perf_counter()
            runners[p](state)
            print(f"phase {p}: {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    if "kernel" in state:
        k = state["kernel"]
        f32 = k["float32"]
        emit({"kernels": [{
            "name": "ragged_paged_attention",
            "route": "cuda",
            "source": "tensorframes_tpu_torch/ops/csrc/ragged_paged_attention.cu",
            "replaces": "tensorframes_tpu/ops/attention.py:433",
            # the main path's count; null when this run did not drive it
            "launches": state.get("launches"),
            "max_abs_err": f32["max_abs_err"],
            "ms": f32["ms"],
            "kernel_ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "bf16": k["bfloat16"],
        }]})
    print(state.get("gpu") or gpu_line(), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())

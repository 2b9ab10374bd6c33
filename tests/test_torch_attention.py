"""The port's paged decode reads held against the JAX package's.

- ``paged_attention`` (the gather) against JAX's gather;
- ``ragged_paged_attention`` on CPU tensors — the plain page walk that the
  CUDA kernel is checked against on the card — against JAX's Pallas
  ``ragged_paged_attention`` in interpret mode (its default off-TPU);
- the same ``_check_paged_inputs`` errors in both packages.

Inputs are made by numpy from a seed and handed to both. The CUDA kernel
itself is held against this plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tensorframes_tpu.ops import attention as J
from tensorframes_tpu_torch.ops import attention as T

pytestmark = pytest.mark.torch

# tests/test_paged_attention.py:133 holds the Pallas kernel to this
TOL = 2e-5


def _case(seed, n_kv, group, hd=16, ps=4, mp=5, pool=14, lengths=None):
    """Ragged lengths with single-token, partial-page, exact-boundary and
    full-table slots, plus an idle slot whose table is all trash."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = [1, 3, 4, 8, 9, ps * mp, 1]
    slots = len(lengths)
    q = rng.normal(size=(slots, n_kv, group, hd)).astype(np.float32)
    kp = rng.normal(size=(pool + 1, ps, n_kv, hd)).astype(np.float32)
    vp = rng.normal(size=(pool + 1, ps, n_kv, hd)).astype(np.float32)
    ptab = rng.integers(0, pool, size=(slots, mp)).astype(np.int32)
    for s, n in enumerate(lengths):
        ptab[s, -(-n // ps):] = pool  # past the length: the trash page
    ptab[-1, :] = pool  # the idle slot
    return q, kp, vp, ptab, np.asarray(lengths, np.int32)


def _to_torch(args, dtype=torch.float32):
    q, kp, vp, ptab, lens = args
    return (
        torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
        torch.from_numpy(vp).to(dtype), torch.from_numpy(ptab),
        torch.from_numpy(lens),
    )


def _to_jax(args, dtype=jnp.float32):
    q, kp, vp, ptab, lens = args
    return (
        jnp.asarray(q).astype(dtype), jnp.asarray(kp).astype(dtype),
        jnp.asarray(vp).astype(dtype), ptab, lens,
    )


SHAPES = pytest.mark.parametrize(
    "n_kv,group", [(3, 1), (2, 2), (1, 4)], ids=["mha", "gqa", "mqa"]
)


@SHAPES
def test_gather_matches_jax(n_kv, group):
    args = _case(0, n_kv, group)
    got = T.paged_attention(*_to_torch(args)).numpy()
    ref = np.asarray(J.paged_attention(*_to_jax(args)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@SHAPES
def test_ragged_plain_path_matches_pallas_interpret(n_kv, group):
    args = _case(1, n_kv, group)
    before = T.ragged_paged_attention.launches
    got = T.ragged_paged_attention(*_to_torch(args))
    # the CPU plain path never counts as a kernel launch
    assert T.ragged_paged_attention.launches == before
    assert got.dtype == torch.float32
    ref = np.asarray(J.ragged_paged_attention(*_to_jax(args), interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
    assert np.isfinite(got.numpy()[-1]).all()  # the trash-page idle slot


def test_ragged_plain_path_every_length_matches_gather():
    # an exhaustive sweep of one slot's length: the boundary-page mask
    # must be right at every offset
    ps, mp = 4, 3
    for n in range(1, ps * mp + 1):
        args = _to_torch(_case(2, 2, 2, ps=ps, mp=mp, pool=8,
                               lengths=[n, ps * mp]))
        np.testing.assert_allclose(
            T.ragged_paged_attention(*args).numpy(),
            T.paged_attention(*args).numpy(),
            rtol=TOL, atol=TOL, err_msg=f"length={n}",
        )


def test_ragged_plain_path_bf16_matches_pallas_interpret():
    args = _case(3, 2, 2)
    got = T.ragged_paged_attention(*_to_torch(args, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    ref = J.ragged_paged_attention(*_to_jax(args, jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2
    )


def _bad_inputs():
    q, kp, vp, ptab, lens = _case(4, 2, 2)
    return {
        "q_rank": (q[0], kp, vp, ptab, lens),
        "pool_rank": (q, kp[0], vp, ptab, lens),
        "kv_shapes": (q, kp, vp[:-1], ptab, lens),
        "pool_heads": (q, kp[:, :, :1], vp[:, :, :1], ptab, lens),
        "table_slots": (q, kp, vp, ptab[:-1], lens),
        "lengths_shape": (q, kp, vp, ptab, lens[:-1]),
        "table_int64": (q, kp, vp, ptab.astype(np.int64), lens),
        "lengths_float": (q, kp, vp, ptab, lens.astype(np.float32)),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_check_paged_inputs_same_errors(case):
    args = _bad_inputs()[case]
    with pytest.raises(ValueError) as jerr:
        J._check_paged_inputs(*args)
    targs = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    for fn in (T._check_paged_inputs, T.paged_attention, T.ragged_paged_attention):
        with pytest.raises(ValueError) as terr:
            fn(*targs)
        # the same error up to the remedy hint (.astype vs .to)
        assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]


def test_kernel_wrapper_takes_only_cpu_or_cuda_tensors():
    args = tuple(t.to("meta") for t in _to_torch(_case(5, 2, 2)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        T.ragged_paged_attention(*args)
    mixed = list(_to_torch(_case(5, 2, 2)))
    mixed[0] = mixed[0].to("meta")
    with pytest.raises(ValueError, match="one device"):
        T.ragged_paged_attention(*mixed)

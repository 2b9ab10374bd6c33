"""The port's transformer serving surface held against the JAX package.

- ``init_transformer`` draws the same weights from a seed;
- ``transformer_prefill`` / ``transformer_step`` / ``transformer_logits``
  give the JAX logits (f32, atol 1e-5) — which checks ``_ln`` (population
  variance, eps inside the sqrt) and the tanh-approximate GELU;
- ``filter_logits`` edge cases;
- ``models/_random``: threefry keys, ``fold_in``, random bits and the
  seeded ``categorical`` bit-exact against ``jax.random``;
- no file of the port imports ``jax`` or ``tensorframes_tpu``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorframes_tpu.models import transformer as JT
from tensorframes_tpu_torch.models import _random as R
from tensorframes_tpu_torch.models import transformer as TT
from tensorframes_tpu_torch.utils.config import resolve_device

pytestmark = pytest.mark.torch

REPO = Path(__file__).resolve().parent.parent
VOCAB = 40
ATOL = 1e-5

CONFIGS = pytest.mark.parametrize(
    "n_kv", [4, 2, 1], ids=["mha", "gqa", "mqa"]
)


def _params(n_kv, seed=0):
    return TT.init_transformer(
        seed, VOCAB, d_model=32, n_heads=4, n_layers=2, max_len=24,
        n_kv_heads=n_kv,
    )


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(np.int32)


@CONFIGS
def test_init_draws_the_reference_weights(n_kv):
    ours = _params(n_kv, seed=7)
    ref = JT.init_transformer(
        7, VOCAB, d_model=32, n_heads=4, n_layers=2, max_len=24,
        n_kv_heads=n_kv,
    )
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    got = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


@CONFIGS
def test_prefill_logits_and_kv_match_jax(n_kv):
    params = _params(n_kv)
    toks = _tokens(1, (2, 9))
    jl, jk, jv = JT.transformer_prefill(params, toks)
    model = TT.params_from_numpy(params, device="cpu")
    with torch.no_grad():
        tl, tk, tv = TT.transformer_prefill(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)


@CONFIGS
def test_step_logits_match_jax(n_kv):
    """One decode step after a prefill, with a dense-cache attend in each
    framework: the per-token walk gives the same logits."""
    params = _params(n_kv)
    toks = _tokens(2, (2, 6))
    nxt = _tokens(3, (2,))
    pos = np.full(2, 6, np.int32)
    hd = 32 // 4
    scale = 1.0 / np.sqrt(hd)
    _, jk, jv = JT.transformer_prefill(params, toks)

    def jattend(li, q, k, v):
        kc = jnp.concatenate([jk[li], k[:, :, None]], axis=2)  # [B, n_kv, T, hd]
        vc = jnp.concatenate([jv[li], v[:, :, None]], axis=2)
        s = jnp.einsum("bkgd,bktd->bkgt", q, kc) * scale
        return jnp.einsum("bkgt,bktd->bkgd", jax.nn.softmax(s, -1), vc).reshape(2, -1)

    jl = JT.transformer_step(params, jnp.asarray(nxt), jnp.asarray(pos), jattend)
    model = TT.params_from_numpy(params, device="cpu")
    with torch.no_grad():
        _, tk, tv = TT.transformer_prefill(model, torch.from_numpy(toks).long())

        def tattend(li, q, k, v):
            kc = torch.cat([tk[li], k[:, :, None]], dim=2)
            vc = torch.cat([tv[li], v[:, :, None]], dim=2)
            s = torch.einsum("bkgd,bktd->bkgt", q, kc) * scale
            return torch.einsum(
                "bkgt,bktd->bkgd", torch.softmax(s, -1), vc
            ).reshape(2, -1)

        tl = TT.transformer_step(
            model, torch.from_numpy(nxt).long(), torch.from_numpy(pos).long(),
            tattend,
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


@CONFIGS
def test_dense_forward_matches_jax(n_kv):
    params = _params(n_kv)
    toks = _tokens(4, (2, 11))
    jl = JT.transformer_logits(params, toks)
    model = TT.params_from_numpy(params, device="cpu")
    with torch.no_grad():
        tl = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_layer_norm_and_gelu_are_the_reference_forms():
    x = np.random.default_rng(5).normal(size=(3, 16)).astype(np.float32) * 4 + 1
    g = np.linspace(0.5, 1.5, 16).astype(np.float32)
    b = np.linspace(-1, 1, 16).astype(np.float32)
    ref = JT._ln(jnp.asarray(x), {"g": g, "b": b})
    got = TT._ln(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6,
    )


def test_moe_params_are_refused():
    params = JT.init_transformer(0, VOCAB, d_model=16, n_heads=2, moe_experts=2)
    with pytest.raises(NotImplementedError):
        TT.params_from_numpy(params, device="cpu")
    with pytest.raises(NotImplementedError):
        TT.init_transformer(0, VOCAB, moe_experts=2)


def test_cuda_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            TT.params_from_numpy(_params(2))
    assert resolve_device("cpu").type == "cpu"


# -- filter_logits ---------------------------------------------------------


@pytest.mark.parametrize(
    "top_k,top_p",
    [(0, 1.0), (3, 1.0), (VOCAB, 1.0), (VOCAB + 5, 1.0), (0, 0.5),
     (0, 1e-6), (4, 0.9), (0, "tensor")],
)
def test_filter_logits_matches_jax(top_k, top_p):
    logits = np.random.default_rng(6).normal(size=(3, VOCAB)).astype(np.float32) * 3
    logits[1, :5] = logits[1].max()  # ties at the top
    if top_p == "tensor":
        tp = np.asarray([[1.0], [0.3], [0.95]], np.float32)
        ref = JT.filter_logits(jnp.asarray(logits), top_k, jnp.asarray(tp))
        got = TT.filter_logits(torch.from_numpy(logits), top_k, torch.from_numpy(tp))
    else:
        ref = JT.filter_logits(jnp.asarray(logits), top_k, top_p)
        got = TT.filter_logits(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_filter_logits_keeps_at_least_one_token():
    logits = torch.tensor([[0.0, 5.0, 1.0]])
    out = TT.filter_logits(logits, 0, 1e-9)
    assert (out > -1e30).sum().item() == 1 and out[0, 1].item() == 5.0


# -- threefry ----------------------------------------------------------------

SEEDS = np.asarray([0, 1, 2, 7, 42, 12345, 2**31 - 1, -1, -77, -(2**31)], np.int32)
POSITIONS = np.asarray([0, 1, 5, 31, 100, 1000, 1056, 4095, 65536, 2**31 - 1], np.int32)


def _jax_keys(seeds, positions):
    return jax.vmap(
        lambda s, t: jax.random.fold_in(jax.random.PRNGKey(s), t)
    )(jnp.asarray(seeds), jnp.asarray(positions))


def _torch_keys(seeds, positions):
    return R.fold_in(R.prng_key(torch.from_numpy(seeds)), torch.from_numpy(positions))


def test_prng_key_and_fold_in_bit_exact():
    seeds = np.repeat(SEEDS, len(POSITIONS))
    positions = np.tile(POSITIONS, len(SEEDS))
    raw = jax.vmap(jax.random.PRNGKey)(jnp.asarray(SEEDS))
    np.testing.assert_array_equal(
        R.prng_key(torch.from_numpy(SEEDS)).numpy(), np.asarray(raw).astype(np.int64)
    )
    np.testing.assert_array_equal(
        _torch_keys(seeds, positions).numpy(),
        np.asarray(_jax_keys(seeds, positions)).astype(np.int64),
    )


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_random_bits_and_uniform_bit_exact(n):
    jk = _jax_keys(SEEDS, POSITIONS)
    tk = _torch_keys(SEEDS, POSITIONS)
    bits = jax.vmap(lambda k: jax.random.bits(k, (n,), dtype=jnp.uint32))(jk)
    np.testing.assert_array_equal(
        R.random_bits(tk, n).numpy(), np.asarray(bits).astype(np.int64)
    )
    tiny = float(np.finfo(np.float32).tiny)
    uni = jax.vmap(
        lambda k: jax.random.uniform(k, (n,), jnp.float32, minval=tiny)
    )(jk)
    np.testing.assert_array_equal(R.uniform(tk, n, tiny).numpy(), np.asarray(uni))


def test_categorical_matches_jax_for_many_seeds_and_positions():
    rng = np.random.default_rng(8)
    seeds = rng.integers(-(2**31), 2**31 - 1, size=400).astype(np.int32)
    positions = rng.integers(0, 2048, size=400).astype(np.int32)
    logits = (rng.normal(size=(400, 64)) * 2).astype(np.float32)
    ref = jax.vmap(jax.random.categorical)(
        _jax_keys(seeds, positions), jnp.asarray(logits)
    )
    got = R.categorical(_torch_keys(seeds, positions), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and the gumbel noise itself agrees to float rounding of log
    g_ref = jax.vmap(lambda k: jax.random.gumbel(k, (64,), jnp.float32))(
        _jax_keys(seeds, positions)
    )
    np.testing.assert_allclose(
        R.gumbel(_torch_keys(seeds, positions), 64).numpy(), np.asarray(g_ref),
        rtol=1e-6, atol=1e-6,
    )


# -- import isolation ----------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((REPO / "tensorframes_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "tensorframes_tpu", "flax"), (
                f"{f.relative_to(REPO)} imports {mod}"
            )

"""PyTorch port, dense-transformer serving path: configs, the flash-attention
suite's plain version and checks, the model functions, and prefill + decode
against the JAX package on the same numpy-made inputs and parameters.

Tolerances.  fp32: both sides compute the same function in float32 and sum
in XLA's and PyTorch's orders, so the flash attention and the small
functions agree to 2e-5 and 1e-6 (the JAX package's own kernel tolerance,
and a few ulps of unit-scale values); logits after a few layers agree to
5e-5 absolute on logits of scale ~3 (measured: below 7e-6).  bf16: both
round to bf16 after every product and elementwise op, but not at the same
places (XLA may fuse or keep fp32 where PyTorch rounds), so logits agree to
3% of their largest magnitude (measured: about 1.5%, two to three bf16
ulps); bf16 attention outputs agree to 2e-2, the JAX package's own
tolerance (one bf16 ulp at 4).

The JAX attention runs through its Pallas kernel in interpret mode
(``use_pallas=True``), as the JAX package's own tests run it on the CPU.
The card test at the end holds the CUDA kernel against the plain version
and skips without a card:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest \\
        tests/test_torch_models.py
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models import (Runtime, common, forward_decode,
                                forward_prefill, init_cache, init_params)
from repro_torch.models import attention as attention_mod
from repro_torch.models import mlp as mlp_mod

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

DENSE = ["smollm-135m", "phi3-mini-3.8b", "yi-34b", "command-r-35b",
         "internvl2-76b"]
ENCODER_DECODER = ["whisper-large-v3"]
# whisper's two kinds of layer the other configs lack
WHISPER_PARTS = ("cross_attn", "encoder_layers")
RT32 = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
RT16 = Runtime()
TOL32 = 5e-5
REL16 = 0.03


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _jrt(jnp, dtype):
    from repro.models import Runtime as JRuntime
    return JRuntime(param_dtype=dtype, compute_dtype=dtype, use_pallas=True)


# --------------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_reference(arch):
    from repro import configs as jconfigs
    assert ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for reduced in (False, True):
        mine, theirs = get_config(arch, reduced), jconfigs.get_config(
            arch, reduced)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.padded_vocab() == theirs.padded_vocab()
        assert (mine.hd, mine.n_periods) == (theirs.hd, theirs.n_periods)
        assert mine.param_count() == theirs.param_count()
        for s in SHAPES:
            assert SHAPES[s].applicable(mine) == \
                jconfigs.SHAPES[s].applicable(theirs)


def test_padded_vocab_rounds_up_to_128():
    assert get_config("smollm-135m").padded_vocab() == 49152
    assert get_config("phi3-mini-3.8b").padded_vocab() == 32128


# --------------------------------------------------------------------------- #
# flash attention: the plain version against the Pallas kernel and oracle
# --------------------------------------------------------------------------- #
def _qkv(B, H, KV, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32),
            rng.standard_normal((B, Sk, KV, hd), dtype=np.float32))


def _port_sdpa(q, k, v, causal, dtype):
    return flash_ops.sdpa(*(torch.as_tensor(a).to(dtype) for a in (q, k, v)),
                          causal=causal).float().numpy()


@pytest.mark.parametrize("B,H,KV,S,hd,causal,bf16", [
    (2, 4, 2, 256, 64, True, False),
    (1, 8, 8, 128, 128, True, False),
    (2, 6, 2, 256, 64, False, False),
    (1, 9, 3, 128, 64, True, False),
    (1, 4, 1, 128, 64, True, True),     # MQA + bf16
    (2, 2, 2, 64, 32, True, False),
])
def test_sdpa_matches_pallas_kernel_and_oracle(B, H, KV, S, hd, causal,
                                               bf16):
    """``ops.sdpa`` on CPU tensors (the plain version) against the JAX
    package's Pallas kernel in interpret mode and its oracle, on the cases
    of the JAX package's own kernel test, in the model layout."""
    jax, jnp = _jax()
    from repro.kernels.flash_attention.flash_attention import flash_attention
    from repro.kernels.flash_attention.ref import attention_ref
    q, k, v = _qkv(B, H, KV, S, S, hd)
    jd = jnp.bfloat16 if bf16 else jnp.float32
    jq, jk, jv = (jnp.asarray(a, jd).swapaxes(1, 2) for a in (q, k, v))
    want_kernel = flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                  block_k=64).swapaxes(1, 2)
    want_ref = attention_ref(jq, jk, jv, causal=causal).swapaxes(1, 2)
    got = _port_sdpa(q, k, v, causal, torch.bfloat16 if bf16
                     else torch.float32)
    tol = 2e-2 if bf16 else 2e-5
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol)


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal", [
    (2, 9, 3, 100, 100, 64, True),     # ragged: no multiple of any tile
    (1, 4, 2, 50, 120, 32, True),      # Sq < Sk, bottom-right causal mask
    (1, 4, 2, 77, 300, 32, False),     # cross-attention shape
])
def test_sdpa_matches_oracle_ragged_and_rectangular(B, H, KV, Sq, Sk, hd,
                                                    causal):
    """Against the JAX package's oracle only: its Pallas kernel takes no
    ragged lengths and masks top-left where Sq < Sk."""
    jax, jnp = _jax()
    from repro.kernels.flash_attention.ref import attention_ref
    q, k, v = _qkv(B, H, KV, Sq, Sk, hd, seed=1)
    want = attention_ref(*(jnp.asarray(a).swapaxes(1, 2) for a in (q, k, v)),
                         causal=causal).swapaxes(1, 2)
    got = _port_sdpa(q, k, v, causal, torch.float32)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def _bad(kind):
    """Causal sdpa arguments that ``ops.sdpa`` must reject."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 4, 2, 16, 16, 32))
    if kind == "dtype":
        return q.half(), k.half(), v.half()
    if kind == "mixed-dtype":
        return q, k.bfloat16(), v
    if kind == "non-contiguous":
        return q.transpose(1, 2).contiguous().transpose(1, 2), k, v
    if kind == "heads":
        return torch.zeros(1, 16, 3, 32), k, v
    if kind == "head-dim":
        return tuple(t[..., :12].contiguous() for t in (q, k, v))
    if kind == "head-dim-160":
        return (torch.zeros(1, 16, 4, 160), torch.zeros(1, 16, 2, 160),
                torch.zeros(1, 16, 2, 160))
    if kind == "shape":
        return q, k, v[:, :8].contiguous()
    assert kind == "causal-sq-gt-sk"
    return q, k[:, :8].contiguous(), v[:, :8].contiguous()


@pytest.mark.parametrize("kind", ["dtype", "mixed-dtype", "non-contiguous",
                                  "heads", "head-dim", "head-dim-160",
                                  "shape", "causal-sq-gt-sk"])
def test_sdpa_rejects_what_the_kernel_does_not_take(kind):
    with pytest.raises((TypeError, ValueError)):
        flash_ops.sdpa(*_bad(kind), causal=True)


def test_sdpa_cpu_calls_do_not_count_as_launches():
    n0 = flash_ops.launches["flash_attention"]
    q, k, v = (torch.as_tensor(a) for a in _qkv(1, 2, 2, 8, 8, 32))
    flash_ops.sdpa(q, k, v, causal=True)
    assert flash_ops.launches["flash_attention"] == n0


def test_sdpa_on_the_card_carries_the_plain_gradient(monkeypatch):
    """Under grad, the card path runs the autograd Function whose forward
    keeps the log-sum-exp and whose backward is the backward kernel: with
    the device check stubbed to say cuda for these CPU tensors and the two
    kernel entry points stubbed by their plain versions, the output carries
    a ``grad_fn`` and the gradient equals autograd of the plain version;
    without grad, or with no input requiring grad, no log-sum-exp is asked
    for."""
    asked = []

    def fwd(q, k, v, causal=True, with_lse=False, causal_offset=None):
        asked.append(with_lse)
        out, lse = flash_ref.attention_lse_ref(q, k, v, causal=causal,
                                               offset=causal_offset)
        return out, (lse if with_lse else None)

    def bwd(q, k, v, out, lse, dout, causal=True, causal_offset=None):
        return flash_ref.attention_bwd_ref(q, k, v, out, lse, dout,
                                           causal=causal,
                                           offset=causal_offset)

    monkeypatch.setattr(flash_ops, "_on_card", lambda t: True)
    monkeypatch.setattr(flash_ops, "forward", fwd)
    monkeypatch.setattr(flash_ops, "backward", bwd)
    q, k, v = (torch.as_tensor(a) for a in _qkv(2, 4, 2, 20, 20, 16))
    g = torch.as_tensor(_qkv(2, 4, 2, 20, 20, 16, seed=1)[0])
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_ops.sdpa(*xs, causal=True)
    assert out.grad_fn is not None and asked == [True]
    got = torch.autograd.grad(out, xs, g)
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ref.attention_ref(*ys), ys, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        flash_ops.sdpa(*xs, causal=True)
    flash_ops.sdpa(q, k, v, causal=True)
    assert asked == [True, False, False]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal", [
    (2, 4, 2, 37, 37, 16, True),     # GQA, ragged
    (1, 6, 1, 20, 33, 8, True),      # MQA, causal Sq < Sk
    (2, 4, 4, 19, 29, 24, False),    # non-causal cross shape
], ids=["gqa", "mqa-rect", "cross"])
def test_attention_bwd_ref_matches_autograd(B, H, KV, Sq, Sk, hd, causal):
    """The backward kernel's decomposition (P from the log-sum-exp,
    D = rowsum(dO o O), dS = P o (dP - D)) against autograd of
    ``attention_ref`` in fp32: 1e-5 of each gradient's largest magnitude
    (the same products summed in another order).  The log-sum-exp comes
    with the output unchanged."""
    q, k, v = (torch.as_tensor(a) for a in _qkv(B, H, KV, Sq, Sk, hd))
    g = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (B, Sq, H, hd), dtype=np.float32))
    out, lse = flash_ref.attention_lse_ref(q, k, v, causal=causal)
    assert torch.equal(out, flash_ref.attention_ref(q, k, v, causal=causal))
    assert lse.shape == (B, H, Sq)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ref.attention_ref(*xs, causal=causal),
                               xs, g)
    got = flash_ref.attention_bwd_ref(q, k, v, out, lse, g, causal=causal)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=1e-5 * float(b.abs().max()))


# --------------------------------------------------------------------------- #
# the small functions
# --------------------------------------------------------------------------- #
def test_norms_match_reference():
    jax, jnp = _jax()
    from repro.models import common as jc
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 48), dtype=np.float32) * 3
    s = rng.uniform(0.5, 1.5, 48).astype(np.float32)
    b = rng.standard_normal(48, dtype=np.float32)
    T = torch.as_tensor
    np.testing.assert_allclose(
        common.rmsnorm(T(x), T(s)).numpy(),
        np.asarray(jc.rmsnorm(jnp.asarray(x), jnp.asarray(s))), atol=1e-6)
    np.testing.assert_allclose(
        common.layernorm(T(x), T(s), T(b)).numpy(),
        np.asarray(jc.layernorm(jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(b))), atol=1e-6)
    # bf16: normalise in fp32, cast, then scale, in both
    got = common.rmsnorm(T(x).bfloat16(), T(s).bfloat16()).float().numpy()
    want = jc.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                      jnp.asarray(s, jnp.bfloat16))
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_rope_matches_reference():
    jax, jnp = _jax()
    from repro.models import common as jc
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 3, 16), dtype=np.float32)
    pos = np.stack([np.arange(7), np.arange(1000, 1007)]).astype(np.int32)
    cos, sin = common.rope_tables(torch.as_tensor(pos), 16, 10_000.0)
    jcos, jsin = jc.rope_tables(jnp.asarray(pos), 16, 10_000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    got = common.apply_rope(torch.as_tensor(x), cos, sin).numpy()
    want = jc.apply_rope(jnp.asarray(x), jcos, jsin)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_sinusoidal_positions_match_reference():
    jax, jnp = _jax()
    from repro.models import common as jc
    np.testing.assert_allclose(common.sinusoidal_positions(40, 32).numpy(),
                               np.asarray(jc.sinusoidal_positions(40, 32)),
                               atol=1e-6)
    np.testing.assert_allclose(
        common.sinusoidal_position_at(37, 32).numpy(),
        np.asarray(jc.sinusoidal_position_at(jnp.int32(37), 32)), atol=1e-6)


@pytest.mark.parametrize("vocab", [512, 500])
def test_logits_for_matches_reference(vocab):
    """fp32 logits of bf16 operands, padded columns at -1e30."""
    jax, jnp = _jax()
    from repro.models import common as jc
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 32), dtype=np.float32)
    w = rng.standard_normal((32, 512), dtype=np.float32) / np.sqrt(32)
    for rt, jd in ((RT32, jnp.float32), (RT16, jnp.bfloat16)):
        got = common.logits_for(torch.as_tensor(x), torch.as_tensor(w), rt,
                                vocab)
        want = jc.logits_for(jnp.asarray(x), jnp.asarray(w), _jrt(jnp, jd),
                             vocab)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        assert (got[..., vocab:] == -1e30).all()


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(act):
    jax, jnp = _jax()
    from repro.models import mlp as jmlp
    cfg = dataclasses.replace(get_config("smollm-135m", True), act=act)
    from repro.configs import get_config as jget
    jcfg = dataclasses.replace(jget("smollm-135m", True), act=act)
    p = jmlp.mlp_init(jax.random.PRNGKey(0), jcfg, _jrt(jnp, jnp.float32))
    x = np.random.default_rng(5).standard_normal((2, 4, cfg.d_model),
                                                 dtype=np.float32)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    got = mlp_mod.mlp(tp, torch.as_tensor(x), cfg, RT32).numpy()
    want = jmlp.mlp(p, jnp.asarray(x), jcfg, _jrt(jnp, jnp.float32),
                    batch=2)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_dense_init_is_a_truncated_normal():
    """+-2 sigma, sigma = fan_in^-1/2, the moments of the JAX package's
    truncated normal, reproducible from the generator's seed."""
    g = torch.Generator().manual_seed(0)
    w = common.dense_init(g, 400, (400, 500), torch.float32)
    sigma = 400 ** -0.5
    assert float(w.abs().max()) <= 2 * sigma * (1 + 1e-6)
    # the standard deviation of a standard normal truncated to [-2, 2]
    assert abs(float(w.std()) / sigma - 0.8796) < 0.005
    assert abs(float(w.mean())) < 0.01 * sigma
    again = common.dense_init(torch.Generator().manual_seed(0), 400,
                              (400, 500), torch.float32)
    assert torch.equal(w, again)


# --------------------------------------------------------------------------- #
# prefill + decode against the JAX package
# --------------------------------------------------------------------------- #
def _both(arch, dtype, *, reduced=True, B=2, S=12, seed=0, **replace):
    """The same numpy-made parameters, tokens and patches in both packages;
    returns JAX's and the port's prefill logits and the logits of one decode
    step after prefill, as fp32 numpy over the true vocabulary."""
    jax, jnp = _jax()
    from repro.configs import get_config as jget
    from repro.models import forward_decode as jdecode
    from repro.models import forward_prefill as jprefill
    from repro.models import init_params as jinit
    jcfg = dataclasses.replace(jget(arch, reduced), **replace)
    cfg = dataclasses.replace(get_config(arch, reduced), **replace)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jrt = _jrt(jnp, jd)
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype)
    jp = jinit(jax.random.PRNGKey(seed), jcfg, jrt)
    tp = model_params_from_numpy(
        jax.tree.map(lambda a: np.array(a, np.float32), jp), cfg, rt,
        device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(toks[:, :S])}, \
        {"tokens": torch.as_tensor(toks[:, :S])}
    vt = cfg.vision_tokens
    if vt:
        pat = rng.standard_normal((B, vt, cfg.d_model), dtype=np.float32)
        jb["patches"] = jnp.asarray(pat, jd)
        tb["patches"] = torch.as_tensor(pat).to(dtype)
    n = S + 1 + vt
    jl, jcache = jprefill(jp, jb, jcfg, jrt, cache_size=n)
    jl2, _ = jdecode(jp, jnp.asarray(toks[:, S:]), jcache, jnp.int32(S + vt),
                     jcfg, jrt)
    tl, cache = forward_prefill(tp, tb, cfg, rt, cache_size=n)
    tl2, _ = forward_decode(tp, torch.as_tensor(toks[:, S:]), cache, S + vt,
                            cfg, rt)
    V = cfg.vocab_size

    def f(a):
        return np.asarray(a, np.float32)[:, :V]

    return (f(jl), f(tl.float())), (f(jl2), f(tl2.float()))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference_fp32(arch):
    for want, got in _both(arch, torch.float32):
        np.testing.assert_allclose(got, want, atol=TOL32)


def test_full_width_smollm_matches_reference_fp32():
    """smollm-135m at its published width (d 576, 9 heads over 3 KV heads,
    hd 64, vocab 49,152) with 2 layers and a 128-token prompt."""
    cfg = get_config("smollm-135m")
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.vocab_size) == (576, 9, 3, 64, 49152)
    for want, got in _both("smollm-135m", torch.float32, reduced=False, B=1,
                           S=128, n_layers=2):
        np.testing.assert_allclose(got, want, atol=TOL32)


@pytest.mark.parametrize("arch,reduced,S,replace", [
    ("smollm-135m", True, 12, {}),
    ("internvl2-76b", True, 12, {}),
    ("smollm-135m", False, 128, {"n_layers": 2}),
], ids=["smollm-reduced", "internvl2-reduced", "smollm-full-width"])
def test_prefill_and_decode_match_reference_bf16(arch, reduced, S, replace):
    for want, got in _both(arch, torch.bfloat16, reduced=reduced, B=1, S=S,
                           **replace):
        np.testing.assert_allclose(got, want,
                                   atol=REL16 * np.abs(want).max())


def test_ragged_prompt_matches_reference():
    """A 130-token prompt: the JAX package leaves its Pallas kernel for
    ``_sdpa_dense`` (130 is no multiple of its 128-row tile); the port's
    kernel path takes it as it is."""
    for want, got in _both("smollm-135m", torch.float32, S=130):
        np.testing.assert_allclose(got, want, atol=TOL32)


def test_sinusoidal_decoder_matches_reference():
    """A dense decoder without RoPE adds sinusoidal positions at prefill and
    at each decode step (no shipped dense config does, whisper's decoder
    does)."""
    for want, got in _both("smollm-135m", torch.float32, rope=False):
        np.testing.assert_allclose(got, want, atol=TOL32)


def test_decode_after_prefill_equals_one_longer_prefill():
    """Exact cache semantics, as the JAX package's own parity test: the
    decode step after a prefill of S tokens gives the logits of a prefill of
    S + 1 tokens."""
    cfg = get_config("phi3-mini-3.8b", reduced=True)
    params = init_params(torch.Generator().manual_seed(1), cfg, RT32)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 13), dtype=np.int32))
    full, _ = forward_prefill(params, {"tokens": toks}, cfg, RT32)
    _, cache = forward_prefill(params, {"tokens": toks[:, :12]}, cfg, RT32,
                               cache_size=13)
    dec, cache2 = forward_decode(params, toks[:, 12:], cache, 12, cfg, RT32)
    assert cache2 is cache
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=TOL32)


def test_init_params_layout_and_cache():
    cfg = get_config("phi3-mini-3.8b", reduced=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, RT16)
    assert len(p["blocks"]) == cfg.n_layers and "lm_head" in p
    assert p["embed"].shape == (cfg.padded_vocab(), cfg.d_model)
    assert all(t.dtype == torch.bfloat16 for t in p["blocks"][0]["mixer"]
               .values())
    tied = init_params(torch.Generator().manual_seed(0),
                       get_config("smollm-135m", True), RT16)
    assert "lm_head" not in tied
    cache = init_cache(cfg, RT16, 2, 9, "cpu")
    assert len(cache) == cfg.n_layers
    assert cache[0]["k"].shape == (2, 9, cfg.n_kv_heads, cfg.hd)


@pytest.mark.parametrize("arch", ENCODER_DECODER)
def test_encoder_decoder_families_serve(arch):
    """The encoder-decoder config initialises (an encoder beside the
    decoder) and serves on the CPU: prefill over stub frames, then a
    decode step, finite logits over the padded vocabulary."""
    cfg = get_config(arch, reduced=True)
    params = init_params(torch.Generator().manual_seed(0), cfg, RT32)
    assert len(params["enc_blocks"]) == cfg.encoder_layers
    fr = torch.randn(1, cfg.encoder_seq, cfg.d_model,
                     generator=torch.Generator().manual_seed(1))
    toks = torch.zeros(1, 4, dtype=torch.int32)
    logits, cache = forward_prefill(params, {"tokens": toks, "frames": fr},
                                    cfg, RT32, cache_size=5)
    assert logits.shape == (1, cfg.padded_vocab())
    logits, _ = forward_decode(params, toks[:, :1], cache, 4, cfg, RT32)
    assert torch.isfinite(logits[:, :cfg.vocab_size]).all()


@pytest.mark.parametrize("what", WHISPER_PARTS)
def test_training_reaches_every_mixer(what):
    """One CPU train step of the reduced whisper moves the parameters of
    its cross-attention (``cross_attn``) and of its audio encoder
    (``encoder_layers``): each gets a nonzero gradient, a finite loss, and
    AdamW updates it."""
    from repro_torch.train.step import (TrainHyper, init_train_state,
                                        make_train_step)
    from repro_torch.tree import tree_items
    cfg = get_config("whisper-large-v3", reduced=True)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, RT32)
    part = (lambda p: p["blocks"][0]["cross"]) if what == "cross_attn" \
        else (lambda p: p["enc_blocks"][0])
    before = {k: v.clone() for k, v in tree_items(part(state["params"]))}
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 9),
                                        dtype=np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": torch.as_tensor(rng.standard_normal(
                 (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32))}
    state, m = make_train_step(cfg, RT32, TrainHyper())(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    moments = dict(tree_items(part(state["opt"]["m"])))
    for path, leaf in tree_items(part(state["params"])):
        assert moments[path].abs().max() > 0, path
        assert not torch.equal(leaf, before[path]), path


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.FLASH_CARD_TEST_SHAPES,
                         ids=lambda s: s[0])
def test_cuda_flash_kernel_matches_plain_version(shape):
    """The CUDA kernel against the plain version on the card, with the
    tolerances ``chip_smoke.flash_error`` states; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n0 = flash_ops.launches["flash_attention"]
    err, tol, _ = chip_smoke.flash_error(shape, torch.device("cuda"))
    assert flash_ops.launches["flash_attention"] == n0 + 1
    assert err <= tol, (shape, err, tol)


@pytest.mark.cuda
def test_cuda_sdpa_gradient_matches_plain_version():
    """On the card a call under grad runs the forward kernel with the
    log-sum-exp and, in the backward, the backward kernel: the gradient
    equals autograd of the plain version within ``chip_smoke``'s fp32
    tolerance; under ``no_grad`` the forward kernel runs alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = (torch.as_tensor(a, device="cuda")
               for a in _qkv(1, 4, 2, 100, 100, 32))
    g = torch.as_tensor(_qkv(1, 4, 2, 100, 100, 32, seed=1)[0],
                        device="cuda")
    n0 = dict(flash_ops.launches)
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(flash_ops.sdpa(*xs, causal=True), xs, g)
    assert flash_ops.launches == {
        "flash_attention": n0["flash_attention"] + 1,
        "flash_attention_bwd": n0["flash_attention_bwd"] + 1}
    ys = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ref.attention_ref(*ys), ys, g)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= \
            chip_smoke.FLASH_BWD_RTOL * float(b.abs().max())
    with torch.no_grad():
        out = flash_ops.sdpa(q, k, v, causal=True)
    assert out.grad_fn is None
    assert flash_ops.launches["flash_attention"] == \
        n0["flash_attention"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.FLASH_BWD_CARD_TEST_SHAPES,
                         ids=lambda s: s[0])
def test_cuda_flash_bwd_kernel_matches_plain_version(shape):
    """The backward kernel (and the forward's log-sum-exp) against the
    plain versions on the card, with the tolerances
    ``chip_smoke.flash_bwd_error`` states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    errs, _ = chip_smoke.flash_bwd_error(shape, torch.device("cuda"))
    for name, (err, tol) in errs.items():
        assert err <= tol, (shape, name, err, tol)


@pytest.mark.cuda
def test_cuda_empty_row_shard_gives_zero_key_gradients():
    """On the card, a qseq rank that the split leaves no rows (100 rows
    over 16 ranks leave the last none) launches neither kernel: its output
    is empty and its dk, dv zero, where the backward kernel, given no row,
    would write none of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn(s, generator=g, device=dev).to(
        torch.bfloat16) for s in ((2, 0, 3, 24), (2, 20, 1, 24),
                                  (2, 20, 1, 24), (2, 0, 3, 24)))
    n0 = dict(flash_ops.launches)
    out, lse = attention_mod.qseq_piece(q, k, v, True, 20)
    dq, dk, dv = attention_mod.piece_bwd(q, k, v, out, lse, dout, True, 20)
    assert flash_ops.launches == n0
    assert out.shape == q.shape and lse.shape == (2, 3, 0)
    assert dq.shape == q.shape and not dk.any() and not dv.any()

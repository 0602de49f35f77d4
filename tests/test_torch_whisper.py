"""PyTorch port, whisper-large-v3 (encoder-decoder with cross-attention),
against the JAX package on the same numpy-made parameters, frames and
tokens: the audio encoder alone, prefill + decode logits, and the init
layout and cache.

Tolerances are those of ``tests/test_torch_models.py`` (fp32: 5e-5 on
outputs and logits of unit scale, both packages computing the same function
in float32 and summing in their own orders).  The JAX side runs its Pallas
flash kernel in interpret mode (``use_pallas=True``) wherever both lengths
are multiples of its tiles; at a ragged encoder length (37 frames) it takes
``_sdpa_dense``, which in fp32 is the same function.  The training path
(loss, one AdamW step with the encoder's weight decay, checkpoints both
ways) and serve's greedy tokens are cases of the parametrized tests in
``test_torch_train.py`` and ``test_torch_serve.py``.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import (Runtime, encode_audio, forward_decode,
                                forward_prefill, init_cache, init_params)

ARCH = "whisper-large-v3"
RT32 = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
TOL32 = 5e-5


def _models(enc_seq=16, seed=0):
    """The reduced whisper (encoder length ``enc_seq``) in both packages
    from the same parameters: (jax, jnp, jcfg, jrt, jparams, cfg,
    params)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import Runtime as JRuntime
    from repro.models import init_params as jinit
    jcfg = dataclasses.replace(jget(ARCH, True), encoder_seq=enc_seq)
    cfg = dataclasses.replace(get_config(ARCH, True), encoder_seq=enc_seq)
    jrt = JRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                   use_pallas=True)
    jp = jinit(jax.random.PRNGKey(seed), jcfg, jrt)
    tp = model_params_from_numpy(
        jax.tree.map(lambda a: np.array(a, np.float32), jp), cfg, RT32,
        device="cpu")
    return jax, jnp, jcfg, jrt, jp, cfg, tp


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)


@pytest.mark.parametrize("enc_seq", [16, 37], ids=["pallas", "ragged"])
def test_encode_audio_matches_reference(enc_seq):
    """The encoder alone (sinusoidal positions, two bidirectional layers,
    the final LayerNorm) on the same frames."""
    from repro.models.transformer import encode_audio as jencode
    jax, jnp, jcfg, jrt, jp, cfg, tp = _models(enc_seq)
    fr = _frames(cfg, 2, 1)
    want = jencode(jp, jnp.asarray(fr), jcfg, jrt, batch=2)
    got = encode_audio(tp, torch.as_tensor(fr), cfg, RT32)
    assert got.shape == (2, enc_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL32)


@pytest.mark.parametrize("enc_seq", [16, 37], ids=["pallas", "ragged"])
def test_prefill_and_decode_match_reference(enc_seq):
    """Prefill of a 12-token prompt over the encoded frames (decoder self-
    and cross-attention through the flash path), then two decode steps
    against the cached self and cross keys and values: the logits of every
    step over the true vocabulary, and the cross cache itself."""
    from repro.models import forward_decode as jdecode
    from repro.models import forward_prefill as jprefill
    jax, jnp, jcfg, jrt, jp, cfg, tp = _models(enc_seq, seed=2)
    B, S, steps = 2, 12, 2
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, S + steps), dtype=np.int32)
    fr = _frames(cfg, B, 4)
    n = S + steps
    jl, jcache = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                               "frames": jnp.asarray(fr)}, jcfg, jrt,
                          cache_size=n)
    tl, cache = forward_prefill(tp, {"tokens": torch.as_tensor(toks[:, :S]),
                                     "frames": torch.as_tensor(fr)},
                                cfg, RT32, cache_size=n)
    V = cfg.vocab_size
    np.testing.assert_allclose(tl.numpy()[:, :V], np.asarray(jl)[:, :V],
                               atol=TOL32)
    for l, c in enumerate(cache):
        for key in ("cross_k", "cross_v"):
            assert c[key].shape == (B, enc_seq, cfg.n_kv_heads, cfg.hd)
            np.testing.assert_allclose(
                c[key].numpy(), np.asarray(jcache["pos0"][key][l]),
                atol=TOL32)
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jdecode(jp, jnp.asarray(tok), jcache, jnp.int32(S + i),
                             jcfg, jrt)
        tl, cache = forward_decode(tp, torch.as_tensor(tok), cache, S + i,
                                   cfg, RT32)
        np.testing.assert_allclose(tl.numpy()[:, :V],
                                   np.asarray(jl)[:, :V], atol=TOL32)


def test_decode_after_prefill_equals_one_longer_prefill():
    """Exact cache semantics with cross-attention: the decode step after a
    prefill of S tokens gives the logits of a prefill of S + 1 tokens over
    the same frames, and leaves the cross cache as it was."""
    cfg = get_config(ARCH, reduced=True)
    params = init_params(torch.Generator().manual_seed(1), cfg, RT32)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9), dtype=np.int32))
    fr = torch.as_tensor(_frames(cfg, 2, 5))
    full, _ = forward_prefill(params, {"tokens": toks, "frames": fr}, cfg,
                              RT32)
    _, cache = forward_prefill(params, {"tokens": toks[:, :8],
                                        "frames": fr}, cfg, RT32,
                               cache_size=9)
    ck = [c["cross_k"].clone() for c in cache]
    dec, _ = forward_decode(params, toks[:, 8:], cache, 8, cfg, RT32)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=TOL32)
    assert all(torch.equal(a, c["cross_k"]) for a, c in zip(ck, cache))


def test_init_params_layout_and_cache():
    """The port's layout: one dict per encoder layer (attention and a GeLU
    MLP, LayerNorm with biases) beside the decoder's, whose layers carry
    ``cross_norm`` and ``cross``; the cache holds the cross keys and
    values at the encoder length."""
    cfg = get_config(ARCH, reduced=True)
    p = init_params(torch.Generator().manual_seed(0), cfg, Runtime())
    assert len(p["enc_blocks"]) == cfg.encoder_layers
    assert len(p["blocks"]) == cfg.n_layers
    assert set(p["enc_blocks"][0]) == {"mixer_norm", "mixer", "ffn_norm",
                                       "ffn"}
    assert set(p["blocks"][0]) == {"mixer_norm", "mixer", "cross_norm",
                                   "cross", "ffn_norm", "ffn"}
    assert set(p["enc_norm"]) == {"scale", "bias"}
    assert p["blocks"][0]["cross"]["wk"].dtype == torch.bfloat16
    cache = init_cache(cfg, Runtime(), 2, 7, "cpu")
    assert cache[0]["k"].shape == (2, 7, cfg.n_kv_heads, cfg.hd)
    assert cache[0]["cross_k"].shape == (2, cfg.encoder_seq,
                                         cfg.n_kv_heads, cfg.hd)

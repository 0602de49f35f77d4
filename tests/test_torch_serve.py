"""PyTorch port, serving entry point and step factories: ``launch.serve.run``
on the CPU against the JAX package's, and the greedy tokens of the port's
prefill and decode steps against the JAX package's on the same parameters.

Greedy tokens must be equal wherever the port's logits' top-2 gap is wider
than 1e-4, twice the fp32 logit tolerance of ``tests/test_torch_models.py``
(5e-5); a closer pair is a near-tie that the two packages' summation
orders may resolve either way.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import Runtime, init_params
from repro_torch.train.step import make_decode_step, make_prefill_step

DENSE = ["smollm-135m", "phi3-mini-3.8b", "yi-34b", "command-r-35b",
         "internvl2-76b"]
MOE = ["jamba-v0.1-52b", "qwen2-moe-a2.7b", "olmoe-1b-7b"]
NEAR_TIE = 1e-4


def _args(*extra):
    return serve.make_parser().parse_args(["--device", "cpu", "--reduced",
                                           *extra])


def test_run_returns_the_reference_keys_and_shapes():
    from repro.launch import serve as jserve
    flags = ["--batch", "2", "--prompt-len", "8", "--gen", "3", "--fp32"]
    want = jserve.run(jserve.make_parser().parse_args(["--reduced", *flags]))
    got = serve.run(_args(*flags))
    assert set(want) <= set(got)
    assert got["generated_shape"] == want["generated_shape"] == [2, 3]
    assert len(got["sample"]) == len(want["sample"]) == 3
    assert got["decode_tok_s"] > 0 and got["prefill_s"] > 0


@pytest.mark.parametrize("arch", DENSE)
def test_run_serves_every_dense_config_on_the_cpu(arch):
    r = serve.run(_args("--arch", arch, "--batch", "2", "--prompt-len", "12",
                        "--gen", "4"))
    vocab = get_config(arch, reduced=True).vocab_size
    assert r["arch"] == arch and r["device"] == "cpu"
    assert r["generated_shape"] == [2, 4]
    assert all(0 <= t < vocab for t in r["sample"])
    assert r["logits_finite"]
    # CPU calls run the plain version: no kernel launches
    assert r["flash_launches"] == {"prefill": 0, "decode": 0}


def test_run_is_reproducible_from_its_seed():
    a = serve.run(_args("--seed", "3", "--gen", "5"))
    b = serve.run(_args("--seed", "3", "--gen", "5"))
    assert a["sample"] == b["sample"]


def test_parser_has_the_reference_flags():
    """The JAX package's flags and defaults, without ``--pallas`` (the
    kernel is what runs on the card) and with ``--device``."""
    from repro.launch import serve as jserve
    want = {a.dest: a.default for a in jserve.make_parser()._actions}
    got = {a.dest: a.default for a in serve.make_parser()._actions}
    assert got.pop("device") == "cuda"
    want.pop("pallas")
    assert got == want


def test_run_serves_whisper():
    """whisper serves through the driver on the CPU: stub frames drawn
    from the seed's stream, encoded in prefill, cross keys and values read
    in decode; finite logits and no kernel launch in either stage."""
    r = serve.run(_args("--arch", "whisper-large-v3", "--batch", "2",
                        "--prompt-len", "6", "--gen", "3"))
    assert r["logits_finite"] and r["generated_shape"] == [2, 3]
    assert r["flash_launches"] == {"prefill": 0, "decode": 0}
    again = serve.run(_args("--arch", "whisper-large-v3", "--batch", "2",
                            "--prompt-len", "6", "--gen", "3"))
    assert again["sample"] == r["sample"]


@pytest.mark.parametrize("arch", MOE)
def test_run_serves_jamba_and_moe(arch):
    """jamba (Mamba + attention + MoE), qwen2-moe and olmoe serve through
    the driver on the CPU: finite logits, the per-stage launch counts of
    every kernel (none on the CPU); a caller's config (``cfg=``, here the
    reduced config cut to one period) replaces ``--arch``'s."""
    cfg = get_config(arch, reduced=True)
    args = _args("--arch", arch, "--batch", "2", "--prompt-len", "9",
                 "--gen", "3")
    for c in (None, dataclasses.replace(cfg, n_layers=len(cfg.period))):
        r = serve.run(args, cfg=c)
        assert r["logits_finite"] and r["generated_shape"] == [2, 3]
        for key in ("ssm_launches", "flash_launches", "mlstm_launches"):
            assert r[key] == {"prefill": 0, "decode": 0}, key


def test_run_serves_xlstm():
    """The reduced xLSTM serves through the driver: stateful prefill and
    decode, finite logits, and no mLSTM kernel launch in either stage."""
    r = serve.run(_args("--arch", "xlstm-1.3b", "--batch", "2",
                        "--prompt-len", "70", "--gen", "3"))
    assert r["logits_finite"] and r["generated_shape"] == [2, 3]
    assert r["mlstm_launches"] == {"prefill": 0, "decode": 0}
    assert r["flash_launches"] == {"prefill": 0, "decode": 0}


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-76b", *MOE,
                                  "whisper-large-v3"])
def test_greedy_tokens_match_reference(arch):
    """Prefill, then five greedy decode steps, in both packages from the
    same parameters and prompt (and whisper's frames; fp32; JAX through
    its Pallas kernel in interpret mode)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models import Runtime as JRuntime
    from repro.models import init_params as jinit
    from repro.train import step as jstep
    jcfg, cfg = jget(arch, reduced=True), get_config(arch, reduced=True)
    jrt = JRuntime(param_dtype=jnp.float32, compute_dtype=jnp.float32,
                   use_pallas=True)
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    jp = jinit(jax.random.PRNGKey(4), jcfg, jrt)
    tp = model_params_from_numpy(
        jax.tree.map(lambda a: np.array(a, np.float32), jp), cfg, rt,
        device="cpu")
    rng = np.random.default_rng(4)
    B, P, steps = 2, 10, 5
    toks = rng.integers(0, cfg.vocab_size, (B, P), dtype=np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    vt = cfg.vision_tokens
    if vt:
        pat = rng.standard_normal((B, vt, cfg.d_model), dtype=np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(pat), torch.as_tensor(pat)
    if cfg.encoder_layers:
        fr = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model),
                                 dtype=np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.as_tensor(fr)
    n = P + vt + steps + 1
    jtok, jcache = jstep.make_prefill_step(jcfg, jrt, cache_size=n)(jp, jb)
    tok, cache, logits = make_prefill_step(cfg, rt, cache_size=n)(tp, tb)
    jdec, dec = jstep.make_decode_step(jcfg, jrt), make_decode_step(cfg, rt)
    for i in range(steps + 1):
        assert tok.dtype == torch.int32
        assert torch.equal(tok, logits.argmax(-1).int())
        top2 = torch.topk(logits[:, :cfg.vocab_size], 2).values
        sure = (top2[:, 0] - top2[:, 1]) > NEAR_TIE
        assert np.array_equal(tok.numpy()[sure.numpy()],
                              np.asarray(jtok)[sure.numpy()]), i
        if i == steps:
            break
        # both continue from the JAX package's pick
        nxt = np.array(jtok)[:, None]
        jtok, jcache = jdec(jp, jnp.asarray(nxt), jcache,
                            jnp.int32(P + vt + i))
        tok, cache, logits = dec(tp, torch.as_tensor(nxt), cache,
                                 P + vt + i)


def test_steps_update_the_cache_in_place():
    cfg = dataclasses.replace(get_config("yi-34b", reduced=True), n_layers=1)
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg, rt)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    tok, cache, _ = make_prefill_step(cfg, rt, cache_size=6)(
        params, {"tokens": toks})
    assert cache[0]["k"].shape[1] == 6
    assert not cache[0]["k"][:, 4:].any()
    k = cache[0]["k"]
    _, cache2, _ = make_decode_step(cfg, rt)(params, tok[:, None], cache, 4)
    assert cache2[0]["k"] is k and k[:, 4].any() and not k[:, 5].any()

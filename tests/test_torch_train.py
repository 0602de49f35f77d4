"""PyTorch port, training path: the chunked cross-entropy, ``forward_train``,
AdamW and its schedule, one train step, int8 error-feedback compression,
the synthetic data pipeline, checkpoints and the training driver, against
the JAX package on the same numpy-made inputs and parameters.

Tolerances (fp32).  Losses agree to 1e-5 relative (measured: below 1e-6):
a mean over tokens of sums taken in other orders.  Gradients, grad norms
and AdamW moments agree to 1e-4 of each leaf's largest magnitude (the
mLSTM gate gradients sum terms of mixed sign; measured: below 2e-5).  The
first AdamW step moves a parameter by about lr * sign(g), so parameters are
compared only where |g| exceeds 1e-3 of its leaf's largest, to 1e-6
absolute.  Host-side parts (data batches, the learning-rate schedule,
int8 quantization, checkpoint arrays) are bit-identical.
"""
import torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.convert import (model_params_from_numpy,
                                 train_state_from_numpy,
                                 train_state_to_numpy)
from repro_torch.data.pipeline import DataConfig, SyntheticLM, host_shard
from repro_torch.models import Runtime, forward_train
from repro_torch.models.common import chunked_cross_entropy
from repro_torch.optim.adamw import AdamWConfig, schedule_lr
from repro_torch.optim.compression import ef_compress_tree, ef_quantize
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.step import (TrainHyper, auto_microbatches,
                                    init_train_state, make_train_step)
from repro_torch.tree import tree_items

DENSE = ["smollm-135m", "phi3-mini-3.8b", "yi-34b", "command-r-35b",
         "internvl2-76b"]
MOE_KEYS = ("moe_lb_loss", "moe_router_z", "moe_drop_frac")
LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
T = torch.as_tensor


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


def _rts(jnp, dtype=torch.float32, **kw):
    """The port's and the JAX package's fp32 runtimes with the same knobs."""
    from repro.models import Runtime as JRuntime
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (Runtime(param_dtype=dtype, compute_dtype=dtype, **kw),
            JRuntime(param_dtype=jd, compute_dtype=jd, **kw))


def _cut(cfg):
    """The reduced xLSTM cut to one mLSTM and one sLSTM layer (a period of
    two), which keeps the JAX package's train-step compile short."""
    return dataclasses.replace(cfg, n_layers=2, period=cfg.period[2:4])


def _jamba_cut(cfg):
    """The reduced jamba cut to one layer of each kind its period has (its
    positions 0, 1 and 4: Mamba + dense, Mamba + MoE, attention + dense),
    as ``chip_smoke`` cuts the full-width one; either package's
    ``LayerSpec``s are taken from its own config."""
    return dataclasses.replace(cfg, n_layers=3, period=tuple(
        cfg.period[i] for i in (0, 1, 4)))


def _first(cfg):
    """A dense reduced config cut to its first two layers."""
    return dataclasses.replace(cfg, n_layers=2)


# (arch, cut) of the train-step tests (the reduced whisper, two encoder
# and two decoder layers, is not cut)
STEP_CONFIGS = {"xlstm-1.3b": _cut, "jamba-v0.1-52b": _jamba_cut,
                "phi3-mini-3.8b": _first, "whisper-large-v3": lambda c: c}


def _np(tree):
    jax, _ = _jax()
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


# --------------------------------------------------------------------------- #
# the loss
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("S,ce_chunk", [(32, 8), (30, 8)],
                         ids=["chunked", "one-chunk"])
def test_chunked_cross_entropy_value_and_gradient(S, ce_chunk):
    """Loss, token count and the gradients with respect to the hidden
    states and the head, with padded vocabulary columns, masked labels and
    the z-loss, against ``repro.models.common.chunked_cross_entropy``."""
    jax, jnp = _jax()
    from repro.models.common import chunked_cross_entropy as jce
    rt, jrt = _rts(jnp, ce_chunk=ce_chunk, z_loss=1e-2)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, S, 16), dtype=np.float32)
    w = rng.standard_normal((16, 128), dtype=np.float32) * 0.5
    labels = rng.integers(0, 100, (2, S)).astype(np.int32)
    labels[0, :5] = -1

    def jloss(xx, ww):
        return jce(xx, ww, jnp.asarray(labels), jnp.asarray(labels >= 0),
                   jrt, 100)

    (jl, jd), (jgx, jgw) = jax.value_and_grad(
        lambda xx, ww: jloss(xx, ww), argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = T(x).requires_grad_(), T(w).requires_grad_()
    loss, denom = chunked_cross_entropy(tx, tw, T(labels), T(labels >= 0),
                                        rt, 100)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    assert float(denom) == float(jd) == 2 * S - 5
    assert _rel(loss, jl) < LOSS_RTOL
    _close(gx.numpy(), np.asarray(jgx), LEAF_RTOL)
    _close(gw.numpy(), np.asarray(jgw), LEAF_RTOL)
    assert float(gw[:, 100:].abs().max()) == 0.0   # padded columns


# --------------------------------------------------------------------------- #
# forward_train against the JAX package
# --------------------------------------------------------------------------- #
def _batch(cfg, B, S, seed, jnp, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    labels = toks[:, 1:].copy()
    labels[:, :2] = -1
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)}
    tb = {"tokens": T(toks[:, :-1]), "labels": T(labels)}
    if cfg.vision_tokens:
        pat = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model),
                                  dtype=np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(pat), T(pat).to(dtype)
    if cfg.encoder_layers:
        fr = _frames(cfg, B, rng)
        jb["frames"], tb["frames"] = jnp.asarray(fr), T(fr).to(dtype)
    return jb, tb


def _frames(cfg, B, rng):
    """Whisper's stub frame embeddings (B, encoder_seq, d)."""
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model),
                               dtype=np.float32)


@pytest.mark.parametrize("arch,S,pallas,bf16_states", [
    *[(a, 16, True, False) for a in DENSE],
    ("xlstm-1.3b", 64, True, False),   # the JAX package's mLSTM kernel path
    ("xlstm-1.3b", 70, False, False),  # its jnp chunked path, ragged
    ("xlstm-1.3b", 70, False, True),   # xLSTM outputs stashed in bf16
    ("jamba-v0.1-52b", 16, True, False),   # its ssm_scan kernel path
    ("jamba-v0.1-52b", 37, False, False),  # its chunked scan, ragged
    ("qwen2-moe-a2.7b", 16, True, False),
    ("olmoe-1b-7b", 16, True, False),
    ("whisper-large-v3", 16, True, False),  # encoder + cross-attention
], ids=[*DENSE, "xlstm-1.3b-kernel", "xlstm-1.3b-ragged",
        "xlstm-1.3b-bf16-states", "jamba-v0.1-52b-kernel",
        "jamba-v0.1-52b-ragged", "qwen2-moe-a2.7b", "olmoe-1b-7b",
        "whisper-large-v3"])
def test_forward_train_loss_matches_reference(arch, S, pallas, bf16_states):
    """The loss (ce + 0.01 lb + 0.001 z), the cross-entropy and the MoE
    auxiliaries summed over layers against the JAX package's; the
    auxiliaries are zero, and the loss is the cross-entropy, without
    MoE."""
    jax, jnp = _jax()
    from repro.configs import get_config as jget
    from repro.models import forward_train as jforward
    from repro.models import init_params as jinit
    cfg, jcfg = get_config(arch, True), jget(arch, True)
    rt, jrt = _rts(jnp, ce_chunk=16, lstm_bf16_states=bf16_states)
    jrt = dataclasses.replace(jrt, use_pallas=pallas, ssm_chunk=16)
    jp = jinit(jax.random.PRNGKey(1), jcfg, jrt)
    tp = model_params_from_numpy(_np(jp), cfg, rt, device="cpu")
    jb, tb = _batch(cfg, 2, S, 1, jnp)
    jl, jm = jforward(jp, jb, jcfg, jrt)
    loss, m = forward_train(tp, tb, cfg, rt)
    # a bf16 stash rounds the outputs that sit on a rounding boundary one
    # bf16 step (2^-8 relative) apart in the two packages
    assert _rel(loss, jl) < (10 * LOSS_RTOL if bf16_states else LOSS_RTOL)
    assert float(m["tokens"]) == float(jm["tokens"])
    if not any(spec.ffn == "moe" for spec in cfg.period):
        assert float(m["ce"]) == float(loss)
        assert all(float(m[k]) == 0.0 for k in MOE_KEYS)
        return
    assert _rel(m["ce"], jm["ce"]) < LOSS_RTOL
    for k in MOE_KEYS[:2]:
        assert _rel(m[k], jm[k]) < LOSS_RTOL, k
    assert float(m["moe_drop_frac"]) == pytest.approx(
        float(jm["moe_drop_frac"]), abs=1e-6)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_same_gradients(policy):
    """``full`` and ``dots`` recompute in the backward; the loss and
    gradients equal those with every activation kept."""
    cfg = _cut(get_config("xlstm-1.3b", True))
    grads = {}
    for pol in ("none", policy):
        rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32,
                     ce_chunk=16, remat_policy=pol)
        p = init_train_state(torch.Generator().manual_seed(0), cfg,
                             rt)["params"]
        leaves = [leaf.requires_grad_() for _, leaf in tree_items(p)]
        _, tb = _batch(cfg, 2, 12, 2, np)
        loss, _ = forward_train(p, tb, cfg, rt)
        grads[pol] = [loss] + list(torch.autograd.grad(loss, leaves))
    for a, b in zip(grads["none"], grads[policy]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# AdamW, the train step, compression
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    jax, jnp = _jax()
    from repro.optim.adamw import AdamWConfig as JCfg
    from repro.optim.adamw import schedule_lr as jsched
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=40, schedule=schedule)
    for step in (0, 3, 6, 7, 8, 20, 39, 40, 55):
        want = float(jsched(JCfg(**kw), jnp.int32(step)))
        assert schedule_lr(AdamWConfig(**kw), step) == want, step


def _step_both(compression, n_micro=2, arch="xlstm-1.3b"):
    """One train step of the cut config (``STEP_CONFIGS``) in both packages
    from the same state and batch (JAX: its differentiable path, jitted).
    Returns (port state, port metrics, JAX state in the port's layout, JAX
    metrics)."""
    jax, jnp = _jax()
    from repro.configs import get_config as jget
    from repro.optim.adamw import AdamWConfig as JCfg
    from repro.train import step as jstep
    cut = STEP_CONFIGS[arch]
    cfg = cut(get_config(arch, True))
    jcfg = cut(jget(arch, True))
    rt, jrt = _rts(jnp, ce_chunk=8, ssm_chunk=4, remat_policy="none")
    opt = dict(lr=3e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jst = jstep.init_train_state(jax.random.PRNGKey(2), jcfg, jrt,
                                 grad_compression=compression)
    state = train_state_from_numpy(_np(jst), cfg, rt, device="cpu")
    assert state["opt"]["step"] == 0
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=7)).batch_at(3)
    if cfg.encoder_layers:
        batch["frames"] = _frames(cfg, 4, np.random.default_rng(7))
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jrt, jstep.TrainHyper(opt=JCfg(**opt),
                                    grad_compression=compression), n_micro))
    jnew, jm = jfn(jst, {k: jnp.asarray(v) for k, v in batch.items()})
    fn = make_train_step(cfg, rt, TrainHyper(opt=AdamWConfig(**opt),
                                             grad_compression=compression),
                         n_micro)
    state, m = fn(state, {k: T(v) for k, v in batch.items()})
    assert _rel(m["loss"], jm["loss"]) < LOSS_RTOL
    assert _rel(m["grad_norm"], jm["grad_norm"]) < LEAF_RTOL
    assert m["lr"] == float(jm["lr"])
    want = train_state_from_numpy(_np(jnew), cfg, rt, "cpu")
    assert state["opt"]["step"] == want["opt"]["step"] == 1
    return state, m, want, jm


def _leaves(state, *keys):
    for k in keys:
        state = state[k]
    return dict(tree_items(state))


def _check_step(state, want):
    """AdamW m and v of every leaf, and the parameters where the gradient
    is not near zero, against the JAX package's step."""
    for key in ("m", "v"):
        theirs = _leaves(want, "opt", key)
        for path, leaf in tree_items(state["opt"][key]):
            _close(leaf.numpy(), theirs[path].numpy(), LEAF_RTOL)
    m1 = _leaves(state, "opt", "m")     # (1 - b1) x the clipped gradient
    theirs = _leaves(want, "params")
    for path, leaf in tree_items(state["params"]):
        gl = m1[path].abs()
        sure = gl > 1e-3 * float(gl.max())
        np.testing.assert_allclose(leaf[sure].numpy(),
                                   theirs[path][sure].numpy(), atol=1e-6)


def test_train_step_matches_reference():
    """One ``make_train_step`` step (two interleaved microbatches, AdamW
    with weight decay) against the JAX package's: loss, grad norm,
    learning rate, step count, AdamW m and v, and the parameters where the
    gradient is not near zero (which also holds the reference's decay rule:
    every block leaf decays, norm scales included, the top-level final norm
    does not)."""
    state, _, want, _ = _step_both("none")
    _check_step(state, want)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "phi3-mini-3.8b",
                                  "whisper-large-v3"])
def test_train_step_matches_reference_with_attention_mamba_and_moe(arch):
    """The same step of the cut reduced jamba (Mamba with and without MoE,
    attention through the flash backward's plain version), of a dense
    config and of the reduced whisper (its encoder, decoder self- and
    cross-attention, the parameters checked also holding the reference's
    decay of every encoder leaf and not of ``enc_norm``): loss (ce plus
    the weighted MoE auxiliaries), grad norm, AdamW m and v,
    parameters."""
    state, m, want, jm = _step_both("none", arch=arch)
    for k in MOE_KEYS:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=LOSS_RTOL,
                                            abs=1e-6), k
    if arch.startswith("jamba"):
        assert float(m["moe_lb_loss"]) > 0.0
    _check_step(state, want)


def test_int8_ef_train_step_matches_reference():
    """One step with int8 error-feedback compression: loss and grad norm,
    and the error-feedback buffers and AdamW m against the JAX package's.
    A gradient entry that lands on a rounding boundary of its leaf's int8
    grid may quantize one step apart in the two packages (the gradients
    differ in the last bits): at most 0.1% of a leaf's entries may differ
    by more than the fp32 tolerance (relative to the leaf's largest
    gradient, 127 steps), and none by more than one step (the step is
    2 max|err|, since |err| <= step / 2)."""
    state, m, want, _ = _step_both("int8_ef")
    clip = min(1.0, 1.0 / float(m["grad_norm"]))
    ef_want = _leaves(want, "ef")
    m_want = _leaves(want, "opt", "m")
    m_got = _leaves(state, "opt", "m")
    for path, err in tree_items(state["ef"]):
        step = 2 * float(ef_want[path].abs().max())
        for got, ref, quantum in ((err, ef_want[path], step),
                                  (m_got[path], m_want[path],
                                   0.1 * clip * step)):
            d = (got - ref).abs()
            loose = d > LEAF_RTOL * 127 * quantum
            assert float(loose.float().mean()) <= 1e-3, path
            assert float(d.max()) <= quantum * (1 + 1e-3) + 1e-12, path


def test_int8_ef_quantize_is_bit_identical():
    """``ef_quantize`` bit for bit against the JAX package's, at three
    gradient scales, and ``ef_compress_tree`` over a nested tree."""
    jax, jnp = _jax()
    from repro.optim.compression import ef_quantize as jq
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 40.0):
        g = (rng.standard_normal((5, 33)) * scale).astype(np.float32)
        e = (rng.standard_normal((5, 33)) * scale * 0.01).astype(np.float32)
        got = ef_quantize(T(g), T(e))
        want = jq(jnp.asarray(g), jnp.asarray(e))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    deq, err = ef_compress_tree({"a": [T(g)]}, {"a": [T(e)]})
    np.testing.assert_array_equal(deq["a"][0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(err["a"][0].numpy(), got[1].numpy())


def test_microbatches_match_full_batch_and_auto_count():
    """Accumulating two interleaved microbatches gives the full batch's loss
    and grad norm; ``auto_microbatches`` picks the reference's count."""
    from repro.configs import get_config as jget
    from repro.configs import SHAPES as JSHAPES
    from repro.train.step import auto_microbatches as jauto
    jax, jnp = _jax()
    _, jrt = _rts(jnp)
    for arch in ("xlstm-1.3b", "yi-34b", "smollm-135m"):
        for shape in ("train_4k", "prefill_32k"):
            assert auto_microbatches(get_config(arch), SHAPES[shape],
                                     Runtime()) == \
                jauto(jget(arch), JSHAPES[shape], jrt)
    cfg = _cut(get_config("xlstm-1.3b", True))
    rt = Runtime(param_dtype=torch.float32, compute_dtype=torch.float32,
                 ce_chunk=8, remat_policy="none")
    out = []
    for n in (1, 2):
        st = init_train_state(torch.Generator().manual_seed(0), cfg, rt)
        data = SyntheticLM(DataConfig(cfg.vocab_size, 16, 4, seed=5))
        _, m = make_train_step(cfg, rt, TrainHyper(), n)(
            st, {k: T(v) for k, v in data.batch_at(0).items()})
        out.append(m)
    # equal token counts per microbatch: the mean of the halves' means
    assert _rel(out[1]["loss"], out[0]["loss"]) < LOSS_RTOL
    assert _rel(out[1]["grad_norm"], out[0]["grad_norm"]) < LEAF_RTOL


# --------------------------------------------------------------------------- #
# data and checkpoints
# --------------------------------------------------------------------------- #
def test_synthetic_lm_is_bit_identical_to_reference():
    from repro.data.pipeline import DataConfig as JD
    from repro.data.pipeline import SyntheticLM as JS
    from repro.data.pipeline import host_shard as jshard
    kw = dict(vocab_size=512, seq_len=33, global_batch=6, seed=11)
    mine, theirs = SyntheticLM(DataConfig(**kw)), JS(JD(**kw))
    np.testing.assert_array_equal(mine.succ, theirs.succ)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        for r in range(3):
            for k in a:
                np.testing.assert_array_equal(host_shard(a, r, 3)[k],
                                              jshard(b, r, 3)[k])
    assert mine.state() == theirs.state()
    mine.restore({"seed": 11, "step": 1})
    np.testing.assert_array_equal(next(mine)["tokens"],
                                  theirs.batch_at(1)["tokens"])


def _checkpoints_cross(tmp_path, dtype, arch):
    """A JAX checkpoint of the cut config restored into the port and the
    port's written back and restored into the JAX package; returns the
    port's checkpoint arrays and the config."""
    jax, jnp = _jax()
    from repro.configs import get_config as jget
    from repro.train import step as jstep
    from repro.train.checkpoint import Checkpointer as JCkpt
    cut = STEP_CONFIGS[arch]
    cfg = cut(get_config(arch, True))
    jcfg = cut(jget(arch, True))
    rt, jrt = _rts(jnp, dtype)
    jst = jstep.init_train_state(jax.random.PRNGKey(4), jcfg, jrt,
                                 grad_compression="int8_ef")
    jst["opt"]["step"] = jnp.int32(9)
    JCkpt(str(tmp_path / "jax"), async_save=False).save(
        9, jst, extra={"data_state": {"seed": 1, "step": 9}})
    template = init_train_state(torch.Generator().manual_seed(0), cfg, rt,
                                grad_compression="int8_ef")
    got, meta = Checkpointer(str(tmp_path / "jax"), cfg).restore(None,
                                                                 template)
    assert meta["step"] == 9 and got["opt"]["step"] == 9
    want = train_state_from_numpy(_np(jst), cfg, rt, "cpu")
    for (path, a), (_, b) in zip(tree_items(got), tree_items(want)):
        if torch.is_tensor(a):
            assert a.dtype == dict(tree_items(template))[path].dtype
            assert torch.equal(a, b), path
    # the port's checkpoint, restored by the JAX package
    got["opt"]["step"] = 12
    ck = Checkpointer(str(tmp_path / "port"), cfg, async_save=False)
    ck.save(12, got, extra={"arch": arch})
    back, meta = JCkpt(str(tmp_path / "port")).restore(None, jst)
    assert meta["arch"] == arch and int(back["opt"]["step"]) == 12
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        if a.ndim:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32))
    assert train_state_to_numpy(got, cfg)["opt"]["step"].dtype == np.int32
    return np.load(tmp_path / "port" / "step_00000012.npz"), cfg


@pytest.mark.parametrize("dtype,arch", [
    (torch.float32, "xlstm-1.3b"), (torch.bfloat16, "xlstm-1.3b"),
    (torch.bfloat16, "whisper-large-v3")],
    ids=["fp32", "bf16", "whisper-bf16"])
def test_checkpoints_cross_both_ways(tmp_path, dtype, arch):
    """A JAX checkpoint restores into the port bit for bit (bf16 leaves
    too), and a port checkpoint restores into the JAX package; both use
    the JAX key layout (whisper's encoder leaves stacked over its layers
    under ``enc_blocks``, with no ``pos<i>`` level)."""
    flat, cfg = _checkpoints_cross(tmp_path, dtype, arch)
    assert flat["params/blocks/pos0/mixer/wq"].shape[0] == cfg.n_periods
    if arch == "xlstm-1.3b":
        assert "params/blocks/pos1/mixer/r" in flat.files
        return
    for key in ("params/enc_blocks/mixer/wq", "opt/m/enc_blocks/ffn/w_up",
                "opt/v/enc_norm/scale", "params/blocks/pos0/cross/wk",
                "ef/enc_blocks/mixer_norm/bias"):
        assert key in flat.files, key
    assert flat["params/enc_blocks/mixer/wq"].shape[0] == cfg.encoder_layers
    assert flat["params/enc_norm/scale"].shape == (cfg.d_model,)


def test_jamba_checkpoints_cross_both_ways(tmp_path):
    """The same for the cut jamba in bf16: the Mamba, MoE (router in fp32
    whatever the parameter dtype) and attention leaves, both ways."""
    flat, cfg = _checkpoints_cross(tmp_path, torch.bfloat16,
                                   "jamba-v0.1-52b")
    for key in ("params/blocks/pos0/mixer/A_log",
                "params/blocks/pos1/ffn/router", "params/blocks/pos1/ffn/wg",
                "opt/m/blocks/pos1/ffn/wd", "opt/v/blocks/pos0/mixer/w_dt",
                "params/blocks/pos2/mixer/wq"):
        assert key in flat.files, key
    assert flat["params/blocks/pos1/ffn/wg"].shape == (
        cfg.n_periods, cfg.n_experts, cfg.d_model, cfg.moe_d_ff)


def test_checkpointer_keeps_the_last_few(tmp_path):
    cfg = get_config("xlstm-1.3b", True)
    st = init_train_state(torch.Generator().manual_seed(0), cfg, Runtime())
    ck = Checkpointer(str(tmp_path), cfg, keep=2)
    for s in (1, 2, 3):
        ck.save(s, st, extra={"s": s})
    ck.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*.npz")) == \
        ["step_00000002.npz", "step_00000003.npz"]
    assert not list(tmp_path.glob(".tmp_*"))
    assert ck.latest_step() == 3


# --------------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------------- #
def test_parser_has_the_reference_flags():
    """The JAX package's flags and defaults (``--arch`` smollm-135m among
    them), without ``--pallas`` and with ``--device``."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    want = {a.dest: a.default for a in jtrain.make_parser()._actions}
    got = {a.dest: a.default for a in train.make_parser()._actions}
    assert got.pop("device") == "cuda"
    want.pop("pallas")
    assert got == want
    assert got["arch"] == "smollm-135m"


def test_train_driver_resumes_bit_for_bit(tmp_path):
    """``launch.train.run`` on the CPU: two steps, a checkpoint, a resumed
    run to step 4 equals an uninterrupted one; the JSON keys of the
    reference plus the port's, and no kernel launch on the CPU."""
    from repro_torch.launch import train
    base = ["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "20", "--warmup", "2", "--verbose"]
    full = train.run(train.make_parser().parse_args(base + ["--steps", "4"]))
    d = str(tmp_path / "ck")
    train.run(train.make_parser().parse_args(
        base + ["--steps", "2", "--ckpt-dir", d, "--ckpt-every", "1"]))
    resumed = train.run(train.make_parser().parse_args(
        base + ["--steps", "4", "--ckpt-dir", d, "--resume"]))
    assert resumed["losses"] == full["losses"][2:]
    for key in ("final_loss", "first_loss", "n_params", "wall_s",
                "grad_norms", "step_s", "tokens_per_s", "mlstm_launches",
                "peak_mem_gib"):
        assert key in full
    assert all(np.isfinite(full["losses"] + full["grad_norms"]))
    assert full["mlstm_launches"] == [{"forward": 0, "backward": 0}] * 4
    assert json.dumps({k: v for k, v in full.items() if k != "losses"})
    assert train.make_parser().parse_args([]).device == "cuda"


def test_train_driver_runs_jamba_and_records_every_kernel():
    """The reduced jamba trains through ``launch.train.run`` on the CPU,
    and a caller's config (``cfg=``) replaces ``--arch``'s: finite losses,
    the MoE drop share and, per step, the launches of every kernel entry
    point (none on the CPU)."""
    from repro_torch.launch import train
    args = train.make_parser().parse_args(
        ["--arch", "jamba-v0.1-52b", "--reduced", "--device", "cpu",
         "--batch", "2", "--seq", "24", "--steps", "2", "--warmup", "1"])
    r = train.run(args)
    cut = _jamba_cut(get_config("jamba-v0.1-52b", True))
    rc = train.run(args, cfg=cut)
    # the analytic count leaves out the norm scales (d each) and Mamba's
    # dt_bias (d_inner per Mamba layer)
    norms = (2 * cut.n_layers + 1) * cut.d_model
    dt_bias = 2 * cut.ssm_d_inner
    assert rc["n_params"] == cut.param_count()["total"] + norms + dt_bias
    assert rc["n_params"] < r["n_params"]
    for out in (r, rc):
        assert all(np.isfinite(out["losses"] + out["grad_norms"]))
        assert len(out["moe_drop_frac"]) == 2
        for key in ("mlstm_launches", "ssm_launches", "flash_launches"):
            assert out[key] == [{"forward": 0, "backward": 0}] * 2, key


def test_train_driver_defaults_to_cuda_and_never_falls_back():
    from repro_torch.launch import train
    args = train.make_parser().parse_args(["--arch", "xlstm-1.3b",
                                           "--reduced", "--steps", "1",
                                           "--batch", "2", "--seq", "8"])
    if torch.cuda.is_available():
        assert train.run(args)["device"].startswith("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.run(args)

"""The port's serving path (``init_cache``, ``prefill_step``, greedy
``decode_step``, ``launch/serve.py``) against the JAX reference, on the
CPU, at lmtiny, rwkv6-smoke and rg-smoke (the RecurrentGemma hybrid,
``--preset recurrentgemma-2b``).

Both sides start from the reference's parameters (handed over through
``repro_torch.bridge``) and the same numpy prompt.  RWKV prompts stay at
most 64 tokens, so the reference's prefill takes its exact ``scan`` path
(beyond 64 it takes ``chunked``, which clamps and is off under the
model's decay).  rg-smoke prompts of 40 and 290 tokens wrap its 32-slot
ring buffer; the reference's prefill takes the RG-LRU's associative scan
at 40 and its chunked form past 256.  On the CPU ``impl="kernel"`` /
``rec_impl="kernel"`` take the kernels' plain versions.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.launch.train import _preset as jpreset
from repro.models import decode_step as jdecode_step
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import prefill_step as jprefill_step

from repro_torch import bridge
from repro_torch.config import (
    FAMILY_AUDIO, FAMILY_SSM, FAMILY_VLM, RecurrentConfig,
)
from repro_torch.configs import get_config
from repro_torch.launch.serve import prompt_tokens, serve
from repro_torch.launch.train import _preset as tpreset
from repro_torch.models import lm
from repro_torch.utils.trees import tree_flatten

from torch_parity import CHILD_ENV

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(preset, dtype):
    jcfg, tcfg = jpreset(preset), tpreset(preset)
    return (dataclasses.replace(jcfg, dtype=dtype),
            dataclasses.replace(tcfg, dtype=dtype))


def _jax_serve(jcfg, params, prompt, gen, forced=None):
    """The reference's serve loop (prefill, then greedy decode), keeping
    every step's logits; ``forced`` feeds these tokens instead of the
    argmax."""
    dt = jnp.bfloat16 if jcfg.dtype == "bfloat16" else jnp.float32
    B, T = prompt.shape
    cache = jinit_cache(jcfg, B, T + gen + 1, dtype=dt)
    prefill = jax.jit(lambda p, c, b: jprefill_step(p, c, b, jcfg))
    decode = jax.jit(lambda p, c, t, pos: jdecode_step(p, c, t, pos, jcfg))
    logits, cache = prefill(params, cache,
                            {"tokens": jnp.asarray(prompt, jnp.int32)})
    steps = [np.asarray(logits.astype(jnp.float32))]
    caches = [jax.device_get(cache)]
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    toks = [np.asarray(tok)]
    for i in range(gen):
        if forced is not None:
            tok = jnp.asarray(forced[:, i:i + 1], jnp.int32)
        logits, cache = decode(params, cache, tok, jnp.int32(T + i))
        steps.append(np.asarray(logits.astype(jnp.float32)))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    caches.append(jax.device_get(cache))
    return np.concatenate(toks, axis=1), steps, caches


def _torch_serve(tcfg, params, prompt, gen, forced=None, **kw):
    dt = torch.bfloat16 if tcfg.dtype == "bfloat16" else torch.float32
    B, T = prompt.shape
    cache = lm.init_cache(tcfg, B, T + gen + 1, dtype=dt, device="cpu")
    with torch.no_grad():
        logits, cache = lm.prefill_step(
            params, cache, {"tokens": torch.from_numpy(prompt)}, tcfg, **kw)
        steps = [logits.float().numpy()]
        caches = [bridge.to_numpy(cache)]
        tok = torch.argmax(logits[:, -1:], dim=-1)
        toks = [tok.numpy()]
        for i in range(gen):
            if forced is not None:
                tok = torch.from_numpy(forced[:, i:i + 1])
            logits, cache = lm.decode_step(params, cache, tok, T + i, tcfg,
                                           **kw)
            steps.append(logits.float().numpy())
            tok = torch.argmax(logits[:, -1:], dim=-1)
            toks.append(tok.numpy())
    caches.append(bridge.to_numpy(cache))
    return np.concatenate(toks, axis=1), steps, caches


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rel,
                               atol=rel * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("preset,prompt_len", [("lmtiny", 40),
                                               ("rwkv6-3b", 40)])
@pytest.mark.parametrize("impls", [("kernel", "kernel"), ("auto", "scan")])
def test_greedy_serve_matches_reference_fp32(preset, prompt_len, impls):
    """Equal greedy tokens over 8 decode steps; every step's logits and
    the caches after prefill and after decode within fp32 tolerance."""
    jcfg, tcfg = _cfgs(preset, "float32")
    params = jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(0))[0])
    prompt = prompt_tokens(tcfg, 3, prompt_len, seed=1)
    jt, jsteps, jcaches = _jax_serve(jcfg, params, prompt, 8)
    tt, tsteps, tcaches = _torch_serve(
        tcfg, bridge.from_numpy(params, CPU), prompt, 8,
        impl=impls[0], rec_impl=impls[1])
    np.testing.assert_array_equal(tt, jt)
    # fp32 matmuls and softmax / recurrence sums in other orders, through
    # 2 layers and the unembedding: 1e-4 of the logits' scale
    for got, want in zip(tsteps, jsteps):
        _close(got, want, 1e-4)
    for tc, jc in zip(tcaches, jcaches):
        tl, jl = tree_flatten(tc)[0], jax.tree.leaves(jc)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            _close(a, b, 1e-4)


@pytest.mark.parametrize("prompt_len", [40, 290])
@pytest.mark.parametrize("impls", [("kernel", "kernel"), ("auto", "scan")])
def test_greedy_serve_matches_reference_fp32_hybrid(prompt_len, impls):
    """rg-smoke: prompts past the 32-token window, so the ring buffer has
    wrapped before decode starts; equal greedy tokens over 6 decode steps,
    every step's logits and the caches within fp32 tolerance."""
    jcfg, tcfg = _cfgs("recurrentgemma-2b", "float32")
    params = jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(0))[0])
    prompt = prompt_tokens(tcfg, 2, prompt_len, seed=1)
    jt, jsteps, jcaches = _jax_serve(jcfg, params, prompt, 6)
    tt, tsteps, tcaches = _torch_serve(
        tcfg, bridge.from_numpy(params, CPU), prompt, 6,
        impl=impls[0], rec_impl=impls[1])
    np.testing.assert_array_equal(tt, jt)
    # fp32 matmuls, softmax and recurrence sums in other orders (past 256
    # tokens the reference's RG-LRU is its chunked closed form), through
    # 3 layers and the unembedding: 1e-4 of the logits' scale
    for got, want in zip(tsteps, jsteps):
        _close(got, want, 1e-4)
    for tc, jc in zip(tcaches, jcaches):
        assert isinstance(tc, list) and len(tc) == tcfg.num_layers
        tl, jl = tree_flatten(tc)[0], jax.tree.leaves(jc)
        assert len(tl) == len(jl)
        for a, b in zip(tl, jl):
            _close(a, b, 1e-4)
    # the attention layer's ring: 32 slots holding the last 32 positions
    ring = tcaches[-1][2]["pos"]
    assert sorted(ring.tolist()) == list(range(prompt_len + 6 - 32,
                                               prompt_len + 6))


@pytest.mark.parametrize("preset", ["lmtiny", "rwkv6-3b",
                                    "recurrentgemma-2b"])
def test_serve_steps_match_reference_bf16(preset):
    """In bf16 each side rounds every activation in its own order, so a
    near-tie may pick another argmax: both sides are fed the reference's
    tokens, and every step's logits agree within bf16 tolerance."""
    jcfg, tcfg = _cfgs(preset, "bfloat16")
    params = jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(2))[0])
    prompt = prompt_tokens(tcfg, 2, 24, seed=3)
    jt, _, _ = _jax_serve(jcfg, params, prompt, 4)
    _, tsteps, _ = _torch_serve(tcfg, bridge.from_numpy(params, CPU),
                                prompt, 4, forced=jt[:, :4],
                                impl="kernel", rec_impl="kernel")
    _, jsteps_forced, _ = _jax_serve(jcfg, params, prompt, 4,
                                     forced=jt[:, :4])
    # about a dozen chained bf16 roundings (2^-8 each) per layer, 2 layers
    for got, want in zip(tsteps, jsteps_forced):
        _close(got, want, 2 ** -4)


@pytest.mark.parametrize("preset", ["lmtiny", "rwkv6-3b",
                                    "recurrentgemma-2b"])
def test_reference_cache_carries_across_the_bridge(preset):
    """The reference's bf16 cache after its prefill crosses the bridge bit
    for bit, and the port's decode step from it matches the reference's."""
    jcfg, tcfg = _cfgs(preset, "bfloat16")
    params = jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(5))[0])
    prompt = prompt_tokens(tcfg, 2, 16, seed=6)
    jcache = jinit_cache(jcfg, 2, 20, dtype=jnp.bfloat16)
    jlogits, jcache = jax.jit(lambda p, c, b: jprefill_step(p, c, b, jcfg))(
        params, jcache, {"tokens": jnp.asarray(prompt, jnp.int32)})
    jcache = jax.device_get(jcache)
    tcache = bridge.from_numpy(jcache, CPU)
    for got, want in zip(tree_flatten(tcache)[0], jax.tree.leaves(jcache)):
        assert str(got.dtype).endswith(str(want.dtype))
        np.testing.assert_array_equal(bridge.to_numpy(got),
                                      np.asarray(want, np.float32)
                                      if want.dtype.name == "bfloat16"
                                      else want)
    tok = np.array(jnp.argmax(jlogits[:, -1:], axis=-1))
    jd, _ = jdecode_step(params, jcache, jnp.asarray(tok, jnp.int32),
                         jnp.int32(16), jcfg)
    with torch.no_grad():
        td, _ = lm.decode_step(bridge.from_numpy(params, CPU), tcache,
                               torch.from_numpy(tok), 16, tcfg,
                               impl="kernel", rec_impl="kernel")
    # bf16 activations rounded in each framework's order, 2 layers
    _close(td.float().numpy(), np.asarray(jd.astype(jnp.float32)), 2 ** -4)


@pytest.mark.parametrize("preset", ["lmtiny", "rwkv6-3b",
                                    "recurrentgemma-2b"])
def test_decode_token_by_token_equals_one_prefill(preset):
    """Prefill of one token then decode of the rest gives every position's
    logits of the full forward, and the same final cache as one prefill
    (the port's twin of the reference's streaming tests)."""
    _, tcfg = _cfgs(preset, "float32")
    params = lm.init_lm(tcfg, 0, CPU)
    toks = torch.from_numpy(prompt_tokens(tcfg, 2, 12, seed=4))
    kw = dict(impl="kernel", rec_impl="kernel")
    with torch.no_grad():
        full = lm.lm_forward(params, toks, tcfg)
        one = lm.init_cache(tcfg, 2, 13, dtype=torch.float32, device="cpu")
        _, one = lm.prefill_step(params, one, {"tokens": toks}, tcfg, **kw)
        stream = lm.init_cache(tcfg, 2, 13, dtype=torch.float32,
                               device="cpu")
        logits, stream = lm.prefill_step(params, stream,
                                         {"tokens": toks[:, :1]}, tcfg, **kw)
        steps = [logits]
        for t in range(1, 12):
            logits, stream = lm.decode_step(params, stream, toks[:, t:t + 1],
                                            t, tcfg, **kw)
            steps.append(logits)
    # fp32, the same operations grouped per step instead of per sequence
    torch.testing.assert_close(torch.cat(steps, dim=1), full, rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(tree_flatten(stream)[0], tree_flatten(one)[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_port_tree_and_count_match_reference_rwkv():
    jcfg, tcfg = jpreset("rwkv6-3b"), tpreset("rwkv6-3b")
    jp = jinit_lm(jcfg, jax.random.PRNGKey(0))[0]
    tp = lm.init_lm(tcfg, 0, CPU)
    jl, tl = jax.tree.leaves(jp), tree_flatten(tp)[0]
    assert [x.shape for x in jl] == [tuple(x.shape) for x in tl]
    assert sum(x.numel() for x in tl) == tcfg.param_count()
    # the published config, by shape only: nothing is allocated
    full = jax.eval_shape(
        lambda: jinit_lm(jget_config("rwkv6-3b"), jax.random.PRNGKey(0))[0])
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
    assert n == get_config("rwkv6-3b").param_count() == 3_099_857_920
    jc = jax.eval_shape(lambda: jinit_cache(jcfg, 2, 9))
    tc = lm.init_cache(tcfg, 2, 9, device="cpu")
    assert [x.shape for x in jax.tree.leaves(jc)] == \
        [tuple(x.shape) for x in tree_flatten(tc)[0]]


def test_port_tree_and_count_match_reference_hybrid():
    jcfg, tcfg = jpreset("recurrentgemma-2b"), tpreset("recurrentgemma-2b")
    jp = jinit_lm(jcfg, jax.random.PRNGKey(0))[0]
    tp = lm.init_lm(tcfg, 0, CPU)
    assert isinstance(tp["blocks"], list)
    assert [sorted(b["mixer"]) for b in tp["blocks"]] == \
        [sorted(b["mixer"]) for b in jp["blocks"]]
    jl, tl = jax.tree.leaves(jp), tree_flatten(tp)[0]
    assert [x.shape for x in jl] == [tuple(x.shape) for x in tl]
    assert sum(x.numel() for x in tl) == tcfg.param_count()
    # the published config, by shape only: nothing is allocated
    for arch, count in (("recurrentgemma-2b", 3_038_753_280),
                        ("rwkv6-3b", 3_099_857_920)):
        full = jax.eval_shape(
            lambda a=arch: jinit_lm(jget_config(a), jax.random.PRNGKey(0))[0])
        n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
        assert n == get_config(arch).param_count() == count
    jc = jax.eval_shape(lambda: jinit_cache(jcfg, 2, 40))
    tc = lm.init_cache(tcfg, 2, 40, device="cpu")
    assert [(x.shape, str(x.dtype)) for x in jax.tree.leaves(jc)] == \
        [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
         for x in tree_flatten(tc)[0]]


@pytest.mark.parametrize("change", [
    dict(family=FAMILY_AUDIO), dict(family=FAMILY_VLM),
    # an RG-LRU config without a pattern (the reference builds RWKV6
    # blocks for it)
    dict(family=FAMILY_SSM, recurrent=RecurrentConfig(kind="rglru")),
])
def test_unported_families_raise(change):
    cfg = dataclasses.replace(tpreset("lmtiny"), **change)
    cfg.validate()
    params = lm.init_lm(tpreset("lmtiny"), 0, CPU)
    cache = lm.init_cache(tpreset("lmtiny"), 1, 4, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int64)
    for call in (lambda: lm.init_lm(cfg, 0, CPU),
                 lambda: lm.init_cache(cfg, 1, 4, device="cpu"),
                 lambda: lm.prefill_step(params, cache, {"tokens": tok}, cfg),
                 lambda: lm.decode_step(params, cache, tok, 0, cfg),
                 lambda: serve(cfg, batch=1, prompt_len=2, gen=1,
                               device="cpu")):
        with pytest.raises(NotImplementedError, match="ported"):
            call()


def test_serve_runs_on_cpu_only_when_asked():
    out = serve(tpreset("rwkv6-3b"), batch=2, prompt_len=5, gen=3,
                device="cpu", keep_logits=True)
    assert out["device"] == "cpu" and out["tokens"].shape == (2, 4)
    assert out["decode_logits"].shape == (2, 1, 256)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve(tpreset("lmtiny"), batch=1, prompt_len=2, gen=1)


def test_serve_cli_prints_json():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--preset",
         "lmtiny", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **CHILD_ENV})
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout)
    assert {"prefill_s", "decode_s", "decode_tok_per_s",
            "generated"} <= set(out)
    assert np.array(out["generated"]).shape == (2, 5)

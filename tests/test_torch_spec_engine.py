"""The port's speculative engine and launcher against the JAX reference.

``ServeEngine(speculate=k)`` on the CPU (the plain kernels at P·G / P·H
verify rows) serves the duplicate trace — prompts followed by verbatim
resends, so the n-gram proposer drafts from completed streams — on the
dense, paged and paged-noprefix layouts, for GQA (``stablelm-1.6b-smoke``)
and MLA (the reference test's 2-layer ``MLA_CFG``), with weights through
the bridge: its greedy streams must equal the port's non-speculative
engine's and the reference's speculative engine's, and its dispatch and
speculation counters the reference's.  Also: preemption on a pool too
small for every slot's draft (no page leaks), fp8 pages (speculative =
non-speculative), the gates (greedy only, global GQA / MLA + dense MLP,
k >= 1; chains of any length, F2 closed), and the launcher's
``--speculate`` / ``--duplicates`` legs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.configs import get_config as jax_get_config
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels.decode import CUDA_MAX_ROWS
from repro_torch.launch import serve
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving.engine import (
    speculation_refusal, speculation_supported,
)

RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
GQA = "stablelm-1.6b-smoke"
MLA_KW = dict(name="mla-spec-test", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, vocab=64)
MLA_LATENT = dict(q_lora_rank=64, kv_lora_rank=32, rope_dim=16, nope_dim=32,
                  v_dim=32)
STAT_KEYS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
             "tokens_decoded", "preemptions", "peak_live_tokens",
             "prefix_hits", "tokens_reused", "cow_copies",
             "tokens_prefilled", "spec_dispatches", "spec_proposed",
             "spec_accepted")
LAYOUTS = [("dense", True), ("paged", True), ("paged", False)]
LAYOUT_IDS = ["dense", "paged", "paged_noprefix"]


def _pair(which: str):
    if which == "gqa":
        jcfg, cfg = jax_get_config(GQA), get_config(GQA)
    else:
        jcfg = JaxModelConfig(**MLA_KW, mla=JaxMLAConfig(**MLA_LATENT))
        cfg = ModelConfig(**MLA_KW, mla=MLAConfig(**MLA_LATENT))
    params, _ = jtf.init(jcfg, jax.random.PRNGKey(0), JRT)
    model = bridge.model_from_jax(cfg, jax.device_get(params), RT,
                                  device="cpu")
    return cfg, jcfg, params, model


def _serve(engine, req_cls, prompts, new_tokens):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


def _engines(pair, prompts, *, new_tokens=12, **kw):
    """The port's and the reference's engine on the same trace."""
    cfg, jcfg, params, model = pair
    kw = dict(dict(slots=2, max_len=64, decode_chunk=8, page_size=8), **kw)
    ours = ServeEngine(cfg, model, rt=RT, device="cpu", **kw)
    theirs = JaxServeEngine(jcfg, params, rt=JRT, **kw)
    return (_serve(ours, Request, prompts, new_tokens), ours,
            _serve(theirs, JaxRequest, prompts, new_tokens), theirs)


def _dup_trace(vocab, seed=0, lens=(7, 12, 5, 9)):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=s).astype(np.int32)
               for s in lens]
    return prompts + [p.copy() for p in prompts[:2]]


@pytest.fixture(scope="module")
def gqa_pair():
    return _pair("gqa")


@pytest.fixture(scope="module", params=["gqa", "mla"])
def spec_runs(request):
    """Per model: the port's non-speculative dense streams, then both
    engines with ``speculate=4`` on each layout, on the duplicate trace."""
    pair = _pair(request.param)
    prompts = _dup_trace(pair[0].vocab)
    cfg, _, _, model = pair
    base = _serve(ServeEngine(cfg, model, rt=RT, device="cpu", slots=2,
                              max_len=64, decode_chunk=8),
                  Request, prompts, 12)
    runs = {lid: _engines(pair, prompts, cache_layout=lo,
                          prefix_caching=pre, speculate=4)
            for lid, (lo, pre) in zip(LAYOUT_IDS, LAYOUTS)}
    return base, runs


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_spec_streams_equal_nonspec_and_the_reference(spec_runs, layout):
    base, runs = spec_runs
    ours, teng, theirs, jeng = runs[layout]
    assert ours == base                 # speculative = non-speculative
    assert ours == theirs               # = the reference's spec engine
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.stats["spec_dispatches"] > 0
    assert teng.stats["spec_accepted"] > 0          # duplicates drafted
    assert teng.logits_finite()
    if teng.kv is not None:
        teng.kv.check_invariants()
        assert teng.memory_stats() == jeng.memory_stats()
        teng.clear_prefix_cache()
        m = teng.kv.memory_stats()
        assert m["pages_in_use"] == {"full": 0}
        assert m["draft_pages"] == {"full": 0}


def test_tiny_pool_preemption_leaks_nothing(gqa_pair):
    """Preemption under speculation on a pool too small for every slot's
    draft: streams equal the dense engine's and the reference's, the
    counters the reference's, and once the trace drains every page is
    free and no scratch reference survives."""
    pair = gqa_pair
    cfg, _, _, model = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
               for s in (12, 14, 11)]
    base = _serve(ServeEngine(cfg, model, rt=RT, device="cpu", slots=2,
                              max_len=64, decode_chunk=8),
                  Request, prompts, 16)
    ours, teng, theirs, jeng = _engines(
        pair, prompts, new_tokens=16, cache_layout="paged", speculate=4,
        num_pages=8, page_size=4)
    assert ours == base == theirs
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.stats["preemptions"] > 0
    assert teng.stats["spec_dispatches"] > 0
    teng.kv.check_invariants()
    teng.clear_prefix_cache()
    c = teng.kv.classes["full"]
    assert c.pool.free_pages == c.pool.num_pages
    assert all(not s for s in c.scratch) and all(not o for o in c.owned)


def test_fp8_paged_speculation_equals_fp8_nonspec(gqa_pair):
    """On fp8 pages the chain is written as codes and scales and every
    read of it sees them dequantized: speculative streams equal the
    non-speculative fp8 engine's, and the reference's fp8 spec engine's,
    counters included."""
    pair = gqa_pair
    cfg, _, _, model = pair
    prompts = _dup_trace(cfg.vocab, seed=4)
    kw = dict(slots=2, max_len=64, decode_chunk=8, page_size=8,
              cache_layout="paged", kv_dtype="fp8_e4m3")
    base = _serve(ServeEngine(cfg, model, rt=RT, device="cpu", **kw),
                  Request, prompts, 12)
    ours, teng, theirs, jeng = _engines(pair, prompts, speculate=4, **kw)
    assert ours == base == theirs
    assert {k: teng.stats[k] for k in STAT_KEYS} == \
        {k: jeng.stats[k] for k in STAT_KEYS}
    assert teng.stats["spec_accepted"] > 0
    teng.kv.check_invariants()


def test_speculation_gates(gqa_pair):
    cfg = get_config(GQA)
    assert speculation_supported(cfg)
    assert not speculation_supported(get_config("gemma2-9b-smoke"))
    assert not speculation_supported(get_config("deepseek-v3-671b-smoke"))
    assert speculation_supported(ModelConfig(**MLA_KW,
                                             mla=MLAConfig(**MLA_LATENT)))
    for name in ("stablelm-1.6b-smoke", "gemma2-9b-smoke",
                 "deepseek-v3-671b-smoke", "granite-3-8b"):
        assert speculation_supported(get_config(name)) == \
            jax_serve_supported(name)
    model = gqa_pair[3]
    kw = dict(slots=2, max_len=64, rt=RT, device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        ServeEngine(cfg, model, temperature=0.7, speculate=2, **kw)
    with pytest.raises(ValueError, match="speculate >= 1"):
        ServeEngine(cfg, model, speculate=0, **kw)
    wcfg = get_config("gemma2-9b-smoke")
    from repro_torch.model import transformer as tf
    wmodel = tf.init(wcfg, 0, RT, device="cpu")
    with pytest.raises(ValueError, match="global GQA/MLA"):
        ServeEngine(wcfg, wmodel, speculate=2, **kw)


def jax_serve_supported(name: str) -> bool:
    from repro.serving.engine import speculation_supported as ref
    return ref(jax_get_config(name))


def test_row_limit_refuses_k_at_construction(gqa_pair):
    """Fault F2 closed: K2 and K3 take any number of folded rows a fiber
    (up to CUDA_MAX_ROWS), so ``speculate=k`` is refused only
    by the reference's gates.  Granite's k = 16 (17 chain positions x G 4
    = 68 rows) and k = 31 (128 rows) are admitted, on the CUDA kernels
    too, as the reference serves them; an MoE config is still refused,
    with the reference's reason."""
    granite = get_config("granite-3-8b")
    assert CUDA_MAX_ROWS == 2**31 - 8
    for k in (15, 16, 31, 100):
        assert speculation_refusal(granite, k, temperature=0.0) is None
    assert speculation_refusal(ModelConfig(**MLA_KW,
                                           mla=MLAConfig(**MLA_LATENT)),
                               100, temperature=0.0) is None
    smoke = get_config("granite-3-8b-smoke")       # G = 4
    assert smoke.n_heads // smoke.n_kv_heads == 4
    model = gqa_pair[3]
    cuda_rt = Runtime(attn_impl="cuda", activation_dtype=torch.float32,
                      param_dtype=torch.float32)
    eng = ServeEngine(get_config(GQA), model, slots=2, max_len=64,
                      rt=cuda_rt, device="cpu", speculate=16)
    assert eng.spec_k == 16 and eng.proposer.k == 17
    moe = get_config("deepseek-v3-671b-smoke")
    assert not speculation_supported(moe) and not jax_serve_supported(
        moe.name)
    why = speculation_refusal(moe, 4, temperature=0.0)
    assert "MoE routing" in why and "speculation_supported" in why
    # the launcher refuses before it builds anything (its device is cuda)
    with pytest.raises(SystemExit, match="MoE routing"):
        serve.main(["--arch", moe.name, "--speculate", "4", "--json", ""])
    # and serves granite's k = 16: 68 verify rows a fiber, streams equal
    # to its non-speculative leg
    got = serve.main(["--device", "cpu", "--arch", smoke.name,
                      "--cache-layout", "both", "--requests", "2",
                      "--slots", "2", "--max-len", "64", "--prompt-len",
                      "6", "--prompt-len-max", "12", "--new-tokens", "8",
                      "--no-warmup", "--speculate", "16", "--duplicates",
                      "2", "--json", ""])
    assert got["outputs_match"] is True
    assert got["speculation"]["k"] == 16
    with pytest.raises(SystemExit, match="greedy-only"):
        serve.main(["--device", "cpu", "--arch", GQA, "--speculate", "2",
                    "--temperature", "0.5", "--json", ""])
    with pytest.raises(SystemExit, match="global GQA/MLA"):
        serve.main(["--device", "cpu", "--speculate", "2", "--json", ""])
    with pytest.raises(SystemExit, match="speculate >= 1"):
        serve.main(["--device", "cpu", "--arch", GQA, "--speculate", "0",
                    "--json", ""])


SPEC_ARGV = ["--device", "cpu", "--arch", GQA, "--cache-layout", "both",
             "--requests", "3", "--slots", "2", "--max-len", "64",
             "--prompt-len", "6", "--prompt-len-max", "14", "--new-tokens",
             "8", "--no-warmup", "--speculate", "4", "--duplicates", "3",
             "--shared-prefix-len", "4", "--kv-dtype", "fp8_e4m3"]


def test_launcher_serves_the_speculation_legs(tmp_path):
    """``--speculate 4 --duplicates 3`` with the other legs on, as the
    reference launcher arranges them: dense, paged and paged_noprefix
    speculative, ``paged_nospec`` (the same trace without speculation,
    which joins outputs_match) and the speculative quantized leg; 3
    requests + 3 verbatim resends; the speculation blocks and the decode
    kernels' launches by draft positions reported (0 on the CPU); and the
    proposer cleared between repeats, so two repeats report what one
    does."""
    out = tmp_path / "spec.json"
    one = serve.main(SPEC_ARGV + ["--repeats", "1", "--json", str(out)])
    two = serve.main(SPEC_ARGV + ["--repeats", "2", "--json", ""])
    assert list(one["layouts"]) == ["dense", "paged", "paged_noprefix",
                                    "paged_nospec", "paged_quant"]
    assert one["outputs_match"] is True and two["outputs_match"] is True
    assert one["duplicates"] == 3 and len(one["_outputs"]) == 6
    assert one["_outputs"][3:] == one["_outputs"][:3]   # resends: same
    for lo, leg in one["layouts"].items():
        assert ("speculation" in leg) == (lo != "paged_nospec"), lo
        assert leg.get("speculation") == two["layouts"][lo].get(
            "speculation"), lo
        assert leg["kernel_launches_by_n_pos"] == {
            "decode_partials": {}, "paged_decode_partials": {},
            "mla_paged_decode_partials": {}, "latent_decode_partials": {}}
        sp = leg.get("speculation")
        if sp is not None:
            assert sp["k"] == 4 and 0 < sp["accepted"] <= sp["proposed"]
            assert sp["dispatches"] <= leg["dispatches"]["decode"]
            assert sp["accepted_per_dispatch"] > 1.0
    nospec = one["layouts"]["paged_nospec"]
    sp = one["speculation"]
    assert sp == dict(one["layouts"]["paged"]["speculation"],
                      spec_vs_base_tok_per_s=sp["spec_vs_base_tok_per_s"])
    assert nospec["dispatches"]["decode_steps"] > \
        one["layouts"]["paged"]["dispatches"]["decode_steps"]
    assert "spec_vs_base_tok_per_s" in out.read_text()

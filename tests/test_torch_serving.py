"""The port's ServeEngine and launcher against the JAX reference engine.

The same trace (numpy-seeded prompts, reference weights through the
bridge) served by ``repro.serving.ServeEngine`` and
``repro_torch.serving.ServeEngine`` on the CPU: greedy streams must be
identical, and so must the dispatch and step counters the card's launch
counts are checked against.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.model import transformer as jtf
from repro.model.layers import Runtime as JaxRuntime
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine

JRT = JaxRuntime(activation_dtype=jnp.float32, param_dtype=jnp.float32)
RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)
NAME = "granite-3-8b-smoke"
COUNTERS = ("prefill_dispatches", "decode_dispatches", "decode_steps",
            "tokens_decoded", "tokens_prefilled", "peak_live_tokens")


def _models(name):
    params, _ = jtf.init(jax_get_config(name), jax.random.PRNGKey(0), JRT)
    model = bridge.model_from_jax(get_config(name), jax.device_get(params),
                                  RT, device="cpu")
    return params, model


@pytest.fixture(scope="module")
def models():
    return _models(NAME)


@pytest.fixture(scope="module")
def gemma7_models():
    return _models("gemma-7b-smoke")


def _serve_both(models, prompts, budgets, name=NAME, **engine_kw):
    params, model = models
    jeng = JaxServeEngine(jax_get_config(name), params, rt=JRT, **engine_kw)
    teng = ServeEngine(get_config(name), model, rt=RT, device="cpu",
                       **engine_kw)
    jreqs = [JaxRequest(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=n)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    for eng, reqs in ((jeng, jreqs), (teng, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    return jeng, jreqs, teng, treqs


@pytest.mark.parametrize("engine_kw", [
    dict(slots=4, max_len=64, decode_chunk=4),
    dict(slots=2, max_len=48, decode_chunk=8, prefill_chunk=8),
], ids=["bucketed", "chunked-prefill"])
def test_same_trace_same_streams_and_counters(models, engine_kw):
    rng = np.random.default_rng(1)
    lens = [5, 17, 9, 30, 3, 12]
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    budgets = [7, 3, 10, 5, 1, 6]
    jeng, jreqs, teng, treqs = _serve_both(models, prompts, budgets,
                                           **engine_kw)
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert [len(r.generated) for r in treqs] == budgets
    assert {k: teng.stats[k] for k in COUNTERS} == \
        {k: jeng.stats[k] for k in COUNTERS}
    assert teng.logits_finite()
    assert teng.memory_stats() == jeng.memory_stats()
    # the dense caches end equal too, zeroed row tails included.  Not the
    # last position: only empty slots (kv_len = 0) write there, and their
    # attention output is 0 in the port (the Pallas semantics) but a mean
    # of V in the reference's jnp executor, so from layer 1 on their K/V
    # differ; no live slot ever reads that position (kv_len < max_len).
    # The reference stacks the run's layers on axis 0.
    last = engine_kw["max_len"] - 1
    for name in ("k", "v"):
        ref = np.asarray(jeng.caches[0][0]["attn"][name])
        for layer, c in enumerate(teng.caches):
            np.testing.assert_allclose(c["attn"][name].numpy()[:, :, :last],
                                       ref[layer][:, :, :last],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_gemma7_same_trace_same_streams_and_counters(gemma7_models, layout):
    """gemma-7b-smoke served by both engines on either layout: equal
    greedy streams and counters."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 17, 9, 30, 3, 12)]
    budgets = [7, 3, 10, 5, 1, 6]
    jeng, jreqs, teng, treqs = _serve_both(
        gemma7_models, prompts, budgets, name="gemma-7b-smoke", slots=4,
        max_len=64, decode_chunk=4, cache_layout=layout)
    assert all(r.done for r in treqs)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert {k: teng.stats[k] for k in COUNTERS} == \
        {k: jeng.stats[k] for k in COUNTERS}
    assert teng.logits_finite()


def test_warmup_resets_counters_and_keeps_streams(models):
    params, model = models
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (6, 20)]
    eng = ServeEngine(get_config(NAME), model, rt=RT, device="cpu", slots=2,
                      max_len=64, decode_chunk=4)
    assert eng.warmup([6, 20]) > 0
    assert all(v == 0 for v in eng.stats.values())
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    cold = ServeEngine(get_config(NAME), model, rt=RT, device="cpu",
                       slots=2, max_len=64, decode_chunk=4)
    creqs = [Request(rid=i, prompt=p, max_new_tokens=5)
             for i, p in enumerate(prompts)]
    for r in creqs:
        cold.submit(r)
    cold.run()
    assert [r.generated for r in reqs] == [r.generated for r in creqs]


def test_engine_defaults_to_cuda_and_never_drifts_to_cpu(models,
                                                         monkeypatch):
    _, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(get_config(NAME), model, slots=2, max_len=32, rt=RT)


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "sharded pool"),
], ids=["kw1-sharded pool"])
def test_unported_engine_options_raise(models, kw, item):
    _, model = models
    with pytest.raises(NotImplementedError, match=item):
        ServeEngine(get_config(NAME), model, slots=2, max_len=32, rt=RT,
                    device="cpu", **kw)


def test_launcher_on_cpu_writes_the_reference_schema(tmp_path):
    out = tmp_path / "bench.json"
    metrics = serve.main(["--device", "cpu", "--requests", "3", "--slots",
                          "2", "--max-len", "64", "--prompt-len", "5",
                          "--prompt-len-max", "20", "--new-tokens", "4",
                          "--repeats", "1", "--no-warmup",
                          "--json", str(out)])
    saved = json.loads(out.read_text())
    assert saved["tokens_decoded"] == 12
    assert saved["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert saved["kernel_launches"] == {"fusemax_prefill": 0,
                                        "decode_partials": 0,
                                        "paged_decode_partials": 0,
                                        "mla_paged_decode_partials": 0,
                                        "latent_decode_partials": 0}
    for key in ("tok_per_s", "ttft_s", "steps_per_s", "dispatches",
                "memory", "layouts", "prefix", "wall_s", "warmup_s"):
        assert key in saved, key
    assert [len(o) for o in metrics["_outputs"]] == [4, 4, 4]


@pytest.mark.parametrize("argv", [
    [],
    ["--prompt-len", "128", "--prompt-len-max", "1024", "--requests", "16"],
    ["--prompt-len", "8", "--prompt-len-max", "40",
     "--shared-prefix-len", "24", "--seed", "3"],
])
def test_launcher_trace_lengths_match_reference(argv):
    """The same flags give the same seeded prompt lengths as the
    reference launcher."""
    from repro.launch import serve as jax_serve

    args = serve._parser().parse_args(argv)
    assert serve._trace_lens(args) == jax_serve._trace_lens(args)


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "tp=2"], "sharded pool"),
    (["--async"], "async"),
], ids=["flag1-sharded pool", "flag2-async"])
def test_launcher_unported_flags_name_their_roadmap_item(flag, item):
    with pytest.raises(SystemExit, match=item):
        serve.main(["--device", "cpu", "--json", ""] + flag)

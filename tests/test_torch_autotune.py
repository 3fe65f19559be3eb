"""The autotuner's measured mode (repro_torch.kernels.autotune).

1. tests/test_autotune.py's two measured cases on the port's keys:
   ``measure_best`` picks the faster candidate and seeds the table that
   ``decode_params`` reads; the winner round-trips through the on-disk
   cache named by ``REPRO_TORCH_AUTOTUNE_CACHE`` after ``clear_table()``.
2. The lookup order: a measured entry wins over the model even after the
   model's answer was memoised; the paged and latent lookups read their
   own keys; a key never holds P, so a verify read keeps the measured
   split of the single-token read.
3. A dense engine (stablelm-1.6b-smoke, ``speculate=4``) under a seeded
   table whose split differs from the model's: every decode and verify
   call takes the seeded split, and the spec stream equals the non-spec
   stream.
"""
import time

import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro_torch.configs import get_config
from repro_torch.kernels import autotune, ops
from repro_torch.model import transformer as tf
from repro_torch.model.layers import Runtime
from repro_torch.serving import Request, ServeEngine


@pytest.fixture(autouse=True)
def fresh_table(monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    autotune.clear_table()
    yield
    autotune.clear_table()


def _seed(key, choice):
    """Put ``choice`` in the table under ``key`` through measure_best."""
    best, _ = autotune.measure_best(lambda c: (lambda: None), [choice],
                                    key=key, iters=1, warmup=0)
    assert best == choice


def test_measure_best_picks_faster_candidate_and_seeds_table():
    def make_fn(cand):
        delay = 0.02 if cand.splits == 1 else 0.0

        def fn():
            time.sleep(delay)

        return fn

    cands = [autotune.DecodeParams(1, 128), autotune.DecodeParams(4, 128)]
    best, timings = autotune.measure_best(
        make_fn, cands, key=autotune.decode_key(256, 8, 64, 64), iters=2,
        warmup=0)
    assert best == cands[1]
    assert timings[cands[0]] > timings[cands[1]]
    hit = autotune.decode_params(256, 8, 64, 64)
    assert (hit.splits, hit.block_k) == (4, 128)


def test_disk_cache_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "sub" / "tune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.clear_table()
    _seed(autotune.decode_key(512, 8, 32, 32), autotune.DecodeParams(2, 256))
    assert path.exists()
    autotune.clear_table()
    hit = autotune.decode_params(512, 8, 32, 32)
    assert (hit.splits, hit.block_k) == (2, 256)
    # without the cache the model answers again
    monkeypatch.delenv(autotune.CACHE_ENV)
    autotune.clear_table()
    assert autotune.decode_params(512, 8, 32, 32) \
        == autotune._modeled_decode(512, 8, 32, 32)


def test_measure_best_skips_refused_candidates_and_raises_when_all_fail():
    def make_fn(cand):
        def fn():
            if cand.splits == 3:
                raise ValueError("M not divisible")
        return fn

    good, bad = autotune.DecodeParams(2, 64), autotune.DecodeParams(3, 64)
    best, timings = autotune.measure_best(make_fn, [bad, good], iters=1,
                                          warmup=0)
    assert best == good and timings[bad] == float("inf")
    with pytest.raises(RuntimeError, match="every candidate failed"):
        autotune.measure_best(make_fn, [bad], iters=1, warmup=0)


def test_time_fn_on_the_cpu():
    x = torch.ones(64, 64)
    assert autotune.time_fn(torch.mm, x, x, iters=3, warmup=1) > 0


def test_measured_entry_wins_over_the_memoised_model():
    modeled = autotune.decode_params(2048, 8, 128, 128)
    other = autotune.DecodeParams(4 if modeled.splits != 4 else 8, 128)
    _seed(autotune.decode_key(2048, 8, 128, 128), other)
    assert autotune.decode_params(2048, 8, 128, 128) == other
    # the group is bucketed, as the reference keys it
    assert autotune.decode_params(2048, 7, 128, 128) == other
    autotune.clear_table()
    assert autotune.decode_params(2048, 8, 128, 128) == modeled


def test_paged_and_latent_lookups_read_their_own_keys():
    p_model = autotune.paged_decode_params(128, 16, 8, 128, 128)
    k_model = autotune.mla_paged_decode_params(128, 16, 128, 512, 64)
    p_other = autotune.DecodeParams(2, 16)
    k_other = autotune.DecodeParams(8, 16)
    assert p_model != p_other and k_model != k_other
    _seed(autotune.paged_decode_key(128, 16, 8, 128, 128), p_other)
    assert autotune.paged_decode_params(128, 16, 8, 128, 128) == p_other
    assert autotune.paged_decode_params(128, 16, 8, 128, 128,
                                        elem_bytes=1) != p_other
    assert autotune.mla_paged_decode_params(128, 16, 128, 512, 64) \
        == k_model
    _seed(autotune.mla_paged_decode_key(128, 16, 128, 512, 64), k_other)
    assert autotune.mla_paged_decode_params(128, 16, 128, 512, 64) \
        == k_other


@pytest.mark.parametrize("p", [1, 5, 13])
def test_measured_split_keys_never_hold_p(p):
    """The verify rows resolve the split of the single-token read: the
    key has no P, and ``verify_block_k`` only ever halves ``block_k``."""
    m, group, d = 2048, 4, 128
    modeled = ops._decode_geometry(m, group, d, d, 1, None, None)
    seeded = autotune.DecodeParams(2 if modeled[0] != 2 else 4, 256)
    _seed(autotune.decode_key(m, max(group, 8), d, d), seeded)
    splits, block_k = ops._decode_geometry(m, group, d, d, p, None, None)
    assert splits == seeded.splits
    assert block_k == autotune.verify_block_k(seeded.block_k, p=p,
                                              g=max(group, 8), e=d, f=d)


# ---------------------------------------------------------------------------
# a dense engine under a seeded table
# ---------------------------------------------------------------------------

RT = Runtime(activation_dtype=torch.float32, param_dtype=torch.float32)


def _streams(cfg, model, prompts, **kw):
    engine = ServeEngine(cfg, model, rt=RT, device="cpu", slots=2,
                         max_len=64, decode_chunk=8, **kw)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    engine.run()
    return [list(r.generated) for r in reqs]


def test_dense_engine_spec_equals_nonspec_under_a_seeded_table(monkeypatch):
    cfg = get_config("stablelm-1.6b-smoke")
    model = tf.init(cfg, 0, RT, device="cpu")
    g = max(cfg.n_heads // cfg.n_kv_heads, 8)
    modeled = autotune.decode_params(64, g, cfg.head_dim, cfg.head_dim)
    seeded = autotune.DecodeParams(2, 32)
    assert seeded != modeled
    _seed(autotune.decode_key(64, g, cfg.head_dim, cfg.head_dim), seeded)

    calls = []
    plain = ops.decode_partials_torch

    def recording(*args, **kw):
        calls.append((kw["splits"], kw["n_pos"]))
        return plain(*args, **kw)

    monkeypatch.setattr(ops, "decode_partials_torch", recording)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=s).astype(np.int32)
               for s in (7, 12, 5, 9)]
    prompts += [p.copy() for p in prompts[:2]]
    base = _streams(cfg, model, prompts, cache_layout="dense")
    spec = _streams(cfg, model, prompts, cache_layout="dense", speculate=4)
    assert spec == base
    assert {s for s, _ in calls} == {seeded.splits}
    assert max(n for _, n in calls) > 1          # verify chains ran

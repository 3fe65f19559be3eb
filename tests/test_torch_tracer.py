"""The port's pass-count tracer (``repro_torch.analysis.trace``) against the
reference's jaxpr tracer (``repro.analysis.lint.trace_m_passes``).

1. Each of the eight ``trace:*`` probes gives the pass count of its
   ``jnp:*`` counterpart, run by the reference on the same probe sizes,
   and a multi-generation list that is empty exactly where the
   reference's is, each shape in it carrying the sequence (144, or both
   3 and 48).  The reference's tracer reads ``jax.core.Literal``, which
   jax 0.9 moved to ``jax.extend.core``; a fixture patches it for these
   tests only.
2. The counterpart of the reference's own tracer test: the 3-pass oracle
   claimed 1-pass is refused with "3 passes".
3. Three loop forms over 48-key tiles — the online loop, a global max
   then one sweep, and the three-loop form — trace 1, 2 and 3 passes;
   the latter two keep K live across a pass barrier.  So do the 2- and
   3-pass forms that keep their tiles, or their scores, from the first
   loop and read them again.
4. Tracing runs the function as it is: its output is bit-equal to an
   untraced call's.
"""
import jax
import jax.extend
import numpy as np
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro.analysis import cascade as jcascade
from repro.analysis import lint as jlint
from repro_torch.analysis import lint
from repro_torch.analysis.cascade import O1, CascadeEntry
from repro_torch.core.taxonomy import attention_1pass
from repro_torch.kernels import decode as dec
from repro_torch.kernels import fusemax as fm
from repro_torch.kernels import ref as kref

M, PAIRS, NEG = 144, ((3, 48),), -1e30

#: the port's probe → (the reference's counterpart, its pass count)
COUNTERPARTS = {
    "trace:mha_reference": ("jnp:mha_reference", 3),
    "trace:decode_reference": ("jnp:decode_reference", 3),
    "trace:attention_2pass": ("jnp:attention_2pass", 2),
    "trace:prefill": ("jnp:flash", 1),
    "trace:decode": ("jnp:decode_splitk", 1),
    "trace:verify": ("jnp:verify_splitk", 1),
    "trace:mla_decode": ("jnp:mla_decode", 1),
    "trace:mla_verify": ("jnp:mla_verify", 1),
}


@pytest.fixture
def jax_literal(monkeypatch):
    monkeypatch.setattr(jax.core, "Literal", jax.extend.core.Literal,
                        raising=False)


def _carries_sequence(shape) -> bool:
    return M in shape or (3 in shape and 48 in shape)


def test_every_trace_probe_has_a_counterpart():
    assert set(COUNTERPARTS) == set(lint.TRACE_PROBES)


@pytest.mark.parametrize("key", sorted(COUNTERPARTS))
def test_trace_probe_equals_reference_tracer(key, jax_literal):
    ref_key, want = COUNTERPARTS[key]
    ref_entry = next(e for e in jcascade.REGISTRY if ref_key in e.lint)
    ref = jlint.PROBES[ref_key](ref_entry)
    got = lint.PROBES[key](None, "torch")
    assert got["traced"] == "plain"
    assert got["passes"] == ref["passes"] == want, (got, ref)
    assert bool(got["multi_gen"]) == bool(ref["multi_gen"]), (got, ref)
    assert all(_carries_sequence(s) for s in got["multi_gen"]), got


def test_tracer_rejects_multipass_claiming_one_pass():
    one_pass_claim = CascadeEntry(
        name="bad-ref-1pass", build=attention_1pass,
        expected_passes=1, footprint=O1, bucket="1-pass")
    args = (torch.zeros(2, 4, 5, 8), torch.zeros(2, 2, M, 8),
            torch.zeros(2, 2, M, 8))
    with pytest.raises(lint.LintError, match="3 passes"):
        lint.assert_torch_path(kref.mha_reference, args, one_pass_claim,
                               m_total=M)


# ---------------------------------------------------------------------------
# loop forms over 48-key tiles
# ---------------------------------------------------------------------------

def _tile(x, t):
    return x[..., t * 48:(t + 1) * 48, :]


#: the same tile of a [2, 4, 144, 8] tensor taken by each indexing call
#: the tracer makes tiles of
TILERS = {
    "getitem": _tile,
    "narrow": lambda x, t: x.narrow(-2, t * 48, 48),
    "index_select": lambda x, t: x.index_select(
        -2, torch.arange(t * 48, (t + 1) * 48)),
    "select": lambda x, t: x.reshape(2, 4, 3, 48, 8).select(2, t),
    "split": lambda x, t: x.split(48, dim=-2)[t],
    "chunk": lambda x, t: torch.chunk(x, 3, dim=-2)[t],
    "unbind": lambda x, t: x.reshape(2, 4, 3, 48, 8).unbind(2)[t],
    "gather": lambda x, t: torch.gather(
        x, -2, torch.arange(t * 48, (t + 1) * 48)[:, None].expand(
            2, 4, 48, 8)),
}


def _scores(q, k, t, tile=_tile):
    return torch.einsum("bhpe,bhme->bhpm", q, tile(k, t))


def online(q, k, v, tile=_tile):
    """The 1-pass cascade: running max, denominator and numerator."""
    rm = torch.full(q.shape[:-1], NEG)
    rd = torch.zeros(q.shape[:-1])
    rnv = torch.zeros(*q.shape[:-1], v.shape[-1])
    for t in range(3):
        s = _scores(q, k, t, tile)
        m_new = torch.maximum(rm, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        c = torch.exp(rm - m_new)
        rd = rd * c + p.sum(-1)
        rnv = rnv * c[..., None] + torch.einsum("bhpm,bhmf->bhpf", p,
                                                tile(v, t))
        rm = m_new
    return rnv / rd[..., None]


def _global_max(q, k, tile=_tile):
    gm = torch.full(q.shape[:-1], NEG)
    for t in range(3):
        gm = torch.maximum(gm, _scores(q, k, t, tile).amax(-1))
    return gm


def max_then_sweep(q, k, v, tile=_tile):
    """2 passes: the global max, then numerator and denominator."""
    gm = _global_max(q, k, tile)
    rd = torch.zeros(q.shape[:-1])
    rnv = torch.zeros(*q.shape[:-1], v.shape[-1])
    for t in range(3):
        p = torch.exp(_scores(q, k, t, tile) - gm[..., None])
        rd = rd + p.sum(-1)
        rnv = rnv + torch.einsum("bhpm,bhmf->bhpf", p, tile(v, t))
    return rnv / rd[..., None]


def three_loops(q, k, v):
    """3 passes: the global max, the denominator, the normalised sum."""
    gm = _global_max(q, k)
    sd = torch.zeros(q.shape[:-1])
    for t in range(3):
        sd = sd + torch.exp(_scores(q, k, t) - gm[..., None]).sum(-1)
    out = torch.zeros(*q.shape[:-1], v.shape[-1])
    for t in range(3):
        a = torch.exp(_scores(q, k, t) - gm[..., None]) / sd[..., None]
        out = out + torch.einsum("bhpm,bhmf->bhpf", a, _tile(v, t))
    return out


def _kept_scores(q, k):
    """Every tile's scores, kept in a list across the loops below."""
    return [torch.einsum("bhpe,bhme->bhpm", q, kt) for kt in k.split(48, -2)]


def _max_of(q, ss):
    gm = torch.full(q.shape[:-1], NEG)
    for s in ss:
        gm = torch.maximum(gm, s.amax(-1))
    return gm


def max_then_sweep_kept_tiles(q, k, v):
    """2 passes: the global max over K's tiles, then a sweep over the
    same tile objects."""
    ks, vs = k.split(48, -2), v.split(48, -2)
    gm = _max_of(q, [torch.einsum("bhpe,bhme->bhpm", q, kt) for kt in ks])
    rd = torch.zeros(q.shape[:-1])
    rnv = torch.zeros(*q.shape[:-1], v.shape[-1])
    for kt, vt in zip(ks, vs):
        p = torch.exp(torch.einsum("bhpe,bhme->bhpm", q, kt)
                      - gm[..., None])
        rd = rd + p.sum(-1)
        rnv = rnv + torch.einsum("bhpm,bhmf->bhpf", p, vt)
    return rnv / rd[..., None]


def max_then_sweep_kept_scores(q, k, v):
    """2 passes, the scores of every tile live across the barrier."""
    ss = _kept_scores(q, k)
    gm = _max_of(q, ss)
    rd = torch.zeros(q.shape[:-1])
    rnv = torch.zeros(*q.shape[:-1], v.shape[-1])
    for s, vt in zip(ss, v.split(48, -2)):
        p = torch.exp(s - gm[..., None])
        rd = rd + p.sum(-1)
        rnv = rnv + torch.einsum("bhpm,bhmf->bhpf", p, vt)
    return rnv / rd[..., None]


def three_loops_kept_scores(q, k, v):
    """3 passes over kept scores: the global max, the denominator, the
    normalised sum."""
    ss = _kept_scores(q, k)
    gm = _max_of(q, ss)
    sd = torch.zeros(q.shape[:-1])
    for s in ss:
        sd = sd + torch.exp(s - gm[..., None]).sum(-1)
    out = torch.zeros(*q.shape[:-1], v.shape[-1])
    for s, vt in zip(ss, v.split(48, -2)):
        a = torch.exp(s - gm[..., None]) / sd[..., None]
        out = out + torch.einsum("bhpm,bhmf->bhpf", a, vt)
    return out


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32))
                 for s in ((2, 4, 5, 8), (2, 4, M, 8), (2, 4, M, 8)))


@pytest.mark.parametrize(
    "fn,passes", [(online, 1), (max_then_sweep, 2), (three_loops, 3),
                  (max_then_sweep_kept_tiles, 2),
                  (max_then_sweep_kept_scores, 2),
                  (three_loops_kept_scores, 3)],
    ids=["online", "max_then_sweep", "three_loops", "kept_tiles",
         "kept_scores", "three_loops_kept_scores"])
def test_loop_forms_trace_their_pass_counts(fn, passes):
    q, k, v = _qkv()
    tr = lint.trace_m_passes(fn, (q, k, v), m_total=M, m_pairs=PAIRS)
    assert tr.passes == passes, tr
    if passes == 1:
        assert tr.multi_gen == [], tr
    else:
        assert tuple(k.shape) in tr.multi_gen, tr
    # the three forms compute the same attention
    torch.testing.assert_close(fn(q, k, v), online(q, k, v),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tiler", sorted(TILERS))
def test_every_indexing_call_makes_tiles(tiler):
    """The online loop and the max-then-sweep loop trace 1 and 2 passes
    whichever indexing call takes their tiles."""
    q, k, v = _qkv()
    tile = TILERS[tiler]
    assert torch.equal(tile(k, 1), _tile(k, 1))
    one = lint.trace_m_passes(lambda *a: online(*a, tile=tile), (q, k, v),
                              m_total=M, m_pairs=PAIRS)
    two = lint.trace_m_passes(lambda *a: max_then_sweep(*a, tile=tile),
                              (q, k, v), m_total=M, m_pairs=PAIRS)
    assert (one.passes, one.multi_gen) == (1, []), one
    assert two.passes == 2 and two.multi_gen, two
    assert all(_carries_sequence(s) for s in two.multi_gen), two


@pytest.mark.parametrize("name", ["online", "max_then_sweep", "three_loops",
                                  "prefill", "decode", "mha_reference"])
def test_tracing_leaves_the_output_bit_equal(name):
    q, k, v = _qkv(1)
    fns = {
        "online": (online, (q, k, v)),
        "max_then_sweep": (max_then_sweep, (q, k, v)),
        "three_loops": (three_loops, (q, k, v)),
        "prefill": (lambda a, b, c: fm.fusemax_attention_torch(
            a.reshape(8, 5, 8), b.reshape(8, M, 8), c.reshape(8, M, 8),
            scale=0.125, block_k=48, causal=True, q_offset=139), (q, k, v)),
        "decode": (lambda a, b, c: dec.combine_partials(
            *dec.decode_partials_torch(
                a[:, :, 0].reshape(4, 2, 8), b.reshape(8, M, 8)[:4],
                c.reshape(8, M, 8)[:4], torch.tensor([100, 40]),
                scale=0.25, hkv=2, splits=3, block_k=16), torch.float32),
            (q, k, v)),
        "mha_reference": (lambda a, b, c: kref.mha_reference(
            a, b[:, :2], c[:, :2], causal=True, q_offset=139), (q, k, v)),
    }
    fn, args = fns[name]
    seen = []
    lint.trace_m_passes(lambda *a: seen.append(fn(*a)), args, m_total=M,
                        m_pairs=PAIRS)
    assert torch.equal(seen[0], fn(*args))

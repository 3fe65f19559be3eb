"""Every config the port admits runs on the card: its head dims are built.

The CUDA kernels are compiled for a fixed set of head dims (K1's
``CUDA_PREFILL_TILES``, K2/K3's ``CUDA_HEAD_DIMS``, K4's
``CUDA_MLA_DIMS``, K2's dense latent branch's ``CUDA_LATENT_DIMS``), and
a CUDA tensor at any other dim raises rather
than falling back to the plain version.  So for each registered arch and
its ``-smoke`` config that ``check_supported`` admits (the launcher
serves each as registered), every (E, F) its
prefill paths reach and every decode head dim / latent must be built on
both cache layouts (an MLA latent: K4 on the paged one, K2's latent
branch on the dense one), or the launcher's default device fails on the
first prefill or decode step.  The tile
choosers must resolve at those dims without raising.  Nothing here needs
the card: the kernels themselves are held to their plain versions at
these dims by ``chip_smoke.py``.

Quantized pages (``kv_dtype`` fp8_e4m3 / int8) take K3's and K4's code
instantiations, built for fp32 queries at every one of those head dims
and latents: each admitted config's quantized pool must reach a built
(dim, code) pair whose shared memory fits, and an unbuilt pair raises.
"""
import pytest
import torch

# -n 6 xdist workers x 8 intra-op threads would oversubscribe 8 cores
torch.set_num_threads(1)

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import decode as dec
from repro_torch.launch import serve
from repro_torch.model import attention as attn
from repro_torch.model import transformer as tf
from repro_torch.serving.kv_cache import PagedKVCache

NAMES = sorted(ARCHS) + sorted(n + "-smoke" for n in ARCHS)


def _admitted(name):
    cfg = get_config(name)
    try:
        tf.check_supported(cfg)
    except NotImplementedError:
        return None
    return cfg


def _kernel_dims(cfg):
    """(prefill (E, F) pairs, GQA decode head dims, MLA (r, rd) latents)
    the config's serving paths reach."""
    prefill, heads, latents = set(), set(), set()
    for spec in cfg.layer_specs():
        if spec.attn == "none":          # an SSM layer: no attention kernel
            continue
        if spec.attn == "mla":
            m = cfg.mla
            prefill.add((m.nope_dim + m.rope_dim, m.v_dim))      # expanded
            prefill.add((m.kv_lora_rank + m.rope_dim, m.kv_lora_rank))
            latents.add((m.kv_lora_rank, m.rope_dim))
        else:
            prefill.add((cfg.dh, cfg.dh))
            heads.add(cfg.dh)
    return prefill, heads, latents


def test_the_admitted_configs_are_the_expected_ones():
    """The guard below is not vacuous: the GQA archs, gemma2's windows and
    softcaps, DeepSeek's MLA with its MoE layers, llama4's GQA MoE,
    hymba's attention beside Mamba and xlstm's attention-free stack are
    all admitted, full width and smoke."""
    admitted = {n for n in NAMES if _admitted(n) is not None}
    for base in ("granite-3-8b", "stablelm-1.6b", "gemma-7b", "gemma2-9b",
                 "deepseek-v3-671b", "llama4-maverick-400b-a17b",
                 "hymba-1.5b", "xlstm-125m"):
        assert {base, base + "-smoke"} <= admitted, base


@pytest.mark.parametrize("name", NAMES)
def test_every_admitted_config_has_its_kernels_built(name):
    cfg = _admitted(name)
    if cfg is None:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tf.check_supported(get_config(name))
        return
    prefill, heads, latents = _kernel_dims(cfg)
    assert prefill <= set(autotune.CUDA_PREFILL_TILES), (name, prefill)
    assert heads <= set(dec.CUDA_HEAD_DIMS), (name, heads)
    assert latents <= set(dec.CUDA_MLA_DIMS), (name, latents)
    assert latents <= set(dec.CUDA_LATENT_DIMS), (name, latents)
    for r, rd in latents:          # the dense latent decode's geometry
        tuned = autotune.decode_params(2048, max(cfg.n_heads, 8), r + rd, r)
        assert 2048 % tuned.splits == 0
    g = cfg.n_heads // (1 if cfg.mla is not None else cfg.n_kv_heads)
    for e, f in prefill:
        tile = autotune.attention_params(1024 * g, 1024, e, f, impl="cuda")
        assert (tile.block_q, tile.block_k) == \
            autotune.CUDA_PREFILL_TILES[(e, f)]


@pytest.mark.parametrize("e,f", [(32, 32), (48, 32), (256, 256)])
def test_prefill_tile_resolves_and_fits(e, f):
    tile = autotune.attention_params(4096, 1024, e, f, impl="cuda")
    wf = autotune.CUDA_PREFILL[(e, f)].warp_split
    assert autotune.prefill_smem_bytes(tile.block_q, tile.block_k, e, f,
                                       wf) <= autotune.SMEM_BUDGET
    assert autotune.prefill_smem_bytes(tile.block_q, tile.block_k, e, f, wf,
                                       elem_bytes=2) <= autotune.SMEM_BUDGET


def test_prefill_smem_mirror_at_the_new_dims():
    """``prefill_smem_bytes`` at the new tiles, as the kernels' layouts
    count them (fp32): (256, 256) on the wgmma body's 64 x 16 with one K
    and one Vᵀ split 229,456 B (two of each at 16 keys would take
    294,992 B, at 32 keys 458,832 B); the smoke dims on the wgmma body's
    64 x 32 with two split buffers, 57,424 B at (32, 32) and 75,856 B at
    (48, 32) (on the mma.sync body's 128 x 64 with K chunks of E itself
    they took 46,080 and 66,560 B)."""
    assert autotune.CUDA_PREFILL_TILES[(256, 256)] == (64, 16)
    assert autotune.prefill_smem_bytes(64, 16, 256, 256, 1) == 229_456
    for bk, want in ((16, 294_992), (32, 458_832)):
        # raw K and V, Q's split, two K and two Vᵀ splits, 10 mbarriers
        got = 4 * bk * 512 + 8 * (64 * 256 + 2 * bk * 256 * 2) + 80
        assert got == want > autotune.SMEM_BUDGET
    assert autotune.CUDA_PREFILL_TILES[(32, 32)] == (64, 32)
    assert autotune.CUDA_PREFILL_TILES[(48, 32)] == (64, 32)
    for e, want in ((32, 57_424), (48, 75_856)):
        # raw K and V, Q's split, two K and two Vᵀ splits, 10 mbarriers
        got = 4 * 32 * (e + 32) + 8 * (64 * e + 2 * 32 * e + 2 * 32 * 32) + 80
        assert autotune.prefill_smem_bytes(64, 32, e, 32, 1) == got == want


@pytest.mark.parametrize("d", [32, 256])
def test_decode_tiles_resolve_at_the_new_head_dims(d):
    for g in (2, 4):
        dense = autotune.decode_params(8192, max(g, 8), d, d)
        assert 8192 % dense.splits == 0
        paged = autotune.paged_decode_params(512, 16, max(g, 8), d, d)
        assert 512 % paged.splits == 0 and 16 % paged.block_k == 0
    for eb in (4, 2):
        for rows in (1, 2, 4, 5, 16, 64):
            dec._check_smem("t", rows, d, eb, 2048)
    # the ring (2 x 16 K and V rows) outweighs the merge of 8 rows at
    # d256; each warp's probabilities and factors take 80 B a block row
    assert autotune.decode_smem_bytes(4, 256, 4, pages=32) \
        == 65_536 + 320 + 128
    assert autotune.decode_smem_bytes(64, 256, 4) == 65_536 + 640
    assert autotune.decode_smem_bytes(64, 32, 2) == 4 * 4 * 8 * 34 + 640


def test_mla_latent_tiles_resolve_at_the_smoke_latent():
    tuned = autotune.mla_paged_decode_params(32, 16, 8, 32, 16)
    assert 32 % tuned.splits == 0 and 16 % tuned.block_k == 0
    assert (32, 16) in dec.CUDA_MLA_DIMS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_latent_smem_twin_matches_the_kernel_layout(dtype):
    """The dense latent kernel takes K4's unquantized shared-memory layout,
    which ``autotune.mla_decode_smem_bytes`` mirrors: a ring of three
    16-key chunks of [ckv | krope] rows in the latents' dtype, each row
    padded by 16 bytes, the 32 query rows of the head block (padded
    alike), then the 8 score warps' fp32 partials, P (rows of 16 + 8
    words) and 32 rescale factors
    (``mla_smem_bytes`` in ``csrc/mla_decode_partials.cuh``; the wrapper
    holds the twin to the library's ``latent_decode_partials_smem_bytes``
    when it loads).  Every built latent fits one block."""
    eb = dtype.itemsize
    tiles = 4 * ((8 + 1) * 32 * 24 + 32)
    want = {(512, 64): (3 * 16 + 32) * (576 * eb + 16) + tiles,
            (32, 16): (3 * 16 + 32) * (48 * eb + 16) + tiles}
    assert set(want) == set(dec.CUDA_LATENT_DIMS)
    for (r, rd), nbytes in want.items():
        assert autotune.mla_decode_smem_bytes(r, rd, eb) == nbytes
        assert nbytes <= autotune.SMEM_BUDGET
    assert autotune.mla_decode_smem_bytes(512, 64, 4) == 213_376


def test_an_unbuilt_dim_raises_and_never_falls_back():
    """A head dim the kernels are not built for is refused at the tile
    choice and by the wrappers' checks; ``impl="cuda"`` on a CPU tensor
    raises too — the plain version is never taken in the kernel's
    place."""
    with pytest.raises(ValueError, match=r"not \(96, 96\)"):
        autotune.attention_params(64, 64, 96, 96, impl="cuda")
    with pytest.raises(ValueError, match="built for"):
        dec._check_head_dims("t", torch.zeros(2, 4, 96))
    dec._check_head_dims("t", torch.zeros(2, 4, 256), torch.zeros(2, 8, 256))
    q = torch.zeros(1, 2, 4, 96)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fusemax_attention(q, q, q, impl="cuda")
    ql, ckv, kr = torch.zeros(1, 4, 1, 64), torch.zeros(1, 16, 48), \
        torch.zeros(1, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fusemax_decode_latent(ql, ckv, kr, torch.tensor([3]),
                                  impl="cuda")


@pytest.mark.parametrize("kv_dtype", ["fp8_e4m3", "int8"])
@pytest.mark.parametrize("name", NAMES)
def test_every_admitted_config_has_its_quantized_kernels_built(name,
                                                               kv_dtype):
    """Every config the launcher admits, under each ``kv_dtype``: its
    decode head dims / latents have K3's / K4's code instantiation (fp32
    queries, the serving dtype), their shared memory fits one block with
    1-byte codes and scale slots at every row count, and a one-page
    quantized pool of the config builds with honest page bytes."""
    cfg = _admitted(name)
    if cfg is None:
        return
    _, heads, latents = _kernel_dims(cfg)
    code = attn.kv_quant_dtype(kv_dtype)
    assert code in dec.QUANT_CODES
    assert heads <= set(dec.CUDA_HEAD_DIMS), (name, heads)
    assert latents <= set(dec.CUDA_MLA_DIMS), (name, latents)
    for d in heads:
        for rows in (1, 4, 5, 64):
            dec._check_smem("t", rows, d, 1, 2048, scaled=True)
    for r, rd in latents:
        assert autotune.mla_decode_smem_bytes(r, rd, 1, scaled=True) \
            <= autotune.SMEM_BUDGET
    kv = PagedKVCache(cfg, 1, 16, torch.float32, page_size=16,
                      kv_dtype=kv_dtype, device="cpu")
    kv.check_invariants()
    for key, c in kv.classes.items():
        layers = [s for s in cfg.layer_specs()
                  if attn.paged_cache_key(s) == key]
        per_token = sum(cfg.mla.kv_lora_rank + cfg.mla.rope_dim + 4
                        if s.attn == "mla"
                        else 2 * cfg.n_kv_heads * (cfg.dh + 2)
                        for s in layers)
        assert c.bytes_per_page == 16 * per_token, (name, key)


def test_an_unbuilt_code_pair_raises_and_never_falls_back():
    """Code pools at an unbuilt head dim, with bf16 queries, or without
    their scales are refused before any launch; the decode shared-memory
    mirror counts 1-byte codes and the scale slots."""
    with pytest.raises(ValueError, match="built for"):
        dec._check_head_dims("t", torch.zeros(2, 4, 96),
                             torch.zeros(4, 16, 2, 96,
                                         dtype=torch.float8_e4m3fn))
    with pytest.raises(ValueError, match="fp32 queries"):
        dec._check_code_pools("t", torch.zeros(2, 4, 128,
                                               dtype=torch.bfloat16),
                              torch.zeros(4, 16, 2, 128, dtype=torch.int8))
    codes = torch.zeros(4, 16, 2, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="scale pools"):
        dec._check_scales("t", codes, (None, None), codes.shape[:3])
    with pytest.raises(ValueError, match="scale pools"):
        dec._check_scales("t", torch.zeros(4, 16, 2, 128),
                          (torch.ones(4, 16, 2, dtype=torch.float16), None),
                          codes.shape[:3])
    ones = torch.ones(4, 16, 2, dtype=torch.float16)
    assert dec._check_scales("t", codes, (ones, ones), codes.shape[:3]) == 1
    # granite: the merge of 4 rows outweighs a ring of 1-byte codes; the
    # scale slots add 2 stages x (K, V) x 16 keys of fp32, the warps'
    # probabilities and factors 80 B a block row
    assert autotune.decode_smem_bytes(4, 128, 1, pages=8) == 8_320 + 320 + 32
    assert autotune.decode_smem_bytes(4, 128, 1, pages=8, scaled=True) \
        == 8_320 + 256 + 320 + 32
    # K4: three code chunks (rows padded by 16 bytes), their scales, one
    # dequantized fp32 chunk (rows padded by 4 floats), the 32 fp32 query
    # rows of the head block and its score / P tiles
    tiles = 4 * ((8 + 1) * 32 * 24 + 32)
    assert autotune.mla_decode_smem_bytes(512, 64, 1, scaled=True) \
        == 3 * 16 * 592 + 384 + 16 * 580 * 4 + 32 * 580 * 4 + tiles
    assert autotune.mla_decode_smem_bytes(512, 64) \
        == (3 * 16 + 32) * 580 * 4 + tiles


def test_launcher_default_is_gemma2_smoke_and_serves():
    """``python -m repro_torch.launch.serve`` with no flags serves
    gemma2-9b-smoke, as the reference launcher does; on the CPU (the one
    flag the card does not need) the trace completes."""
    args = serve._parser().parse_args([])
    assert (args.arch, args.device, args.cache_layout) == \
        ("gemma2-9b-smoke", "cuda", "dense")
    metrics = serve.main(["--device", "cpu", "--json", "", "--repeats", "1",
                          "--no-warmup", "--cache-layout", "both"])
    assert metrics["arch"] == "gemma2-9b-smoke"
    assert metrics["outputs_match"] is True
    assert [len(o) for o in metrics["_outputs"]] == [12] * 6

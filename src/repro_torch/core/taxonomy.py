"""Symbolic cascades from the paper + the attention taxonomy (§III-IV).

Every cascade below is transcribed from the paper (equation numbers in
comments).  The pass analysis in :mod:`repro_torch.core.passes` reproduces
Table I: PyTorch/TF/FLAT-style numerically-stable attention is a 3-pass
cascade over the sequence rank M, TileFlow/Choi is 2-pass, and
FlashAttention-2 (the cascade FuseMax adopts) is 1-pass.

Numeric counterparts (actual JAX computations proven equivalent to each
other in tests) live in :mod:`repro_torch.core.cascades_numeric`.
"""
from __future__ import annotations

from repro_torch.core.einsum import Cascade, Einsum, T


# ---------------------------------------------------------------------------
# Pedagogical cascades (paper §III, Cascades 1-3)
# ---------------------------------------------------------------------------

def cascade1_two_pass_example() -> Cascade:
    """Cascade 1: Y = Σ_k A_k B_k ; Z = Σ_k Y·A_k  — 2 passes over K."""
    c = Cascade("cascade1-2pass-example")
    c.add(Einsum(T("Y"), (T("A", "K"), T("B", "K"))))              # Eq. 5
    c.add(Einsum(T("Z"), (T("Y"), T("A", "K"))))                   # Eq. 6
    return c


def cascade2_deferred_multiply() -> Cascade:
    """Cascade 2 (§III-C1): defer the Y× — 1 pass over K, fewer multiplies."""
    c = Cascade("cascade2-deferred-multiply")
    c.add(Einsum(T("Y"), (T("A", "K"), T("B", "K"))))              # Eq. 7
    c.add(Einsum(T("X"), (T("A", "K"),)))                          # Eq. 8
    c.add(Einsum(T("Z"), (T("Y"), T("X"))))                        # Eq. 9
    return c


def cascade3_iterative() -> Cascade:
    """Cascade 3 (§III-C2): iterative construction — 1 pass over K.

    The iteration variable ``I`` walks rank K (alias).  ``RY``/``RZ`` are
    iterative tensors; their self-references are prefix-only dependencies.
    """
    c = Cascade("cascade3-iterative")
    c.alias("I", "K")
    c.add(Einsum(T("RY", "I*"), (), init=True))                    # Eq. 10
    c.add(Einsum(T("RZ", "I*"), (), init=True))                    # Eq. 11
    # RY_{i+1} = RY_i + A_i × B_i                                  # Eq. 12
    c.add(Einsum(T("RY", "I*"), (T("RY", "I*"), T("A", "I*"), T("B", "I*"))))
    # RZ_{i+1} = RZ_i × RY_{i+1}/RY_i + RY_{i+1} × A_i             # Eq. 13
    c.add(Einsum(T("RZ", "I*"), (T("RZ", "I*"), T("RY", "I*"), T("A", "I*"))))
    c.add(Einsum(T("Z"), (T("RZ", "I$"),)))                        # Eq. 14
    return c


# ---------------------------------------------------------------------------
# Attention cascades (paper §IV)
# ---------------------------------------------------------------------------

def attention_qk_av(c: Cascade, *, deferred_division: bool) -> None:
    """Shared prologue/epilogue: QK (Eq. 22) and AV (Eq. 24 / Eqs. 31-32)."""
    c.add(Einsum(T("QK", "M", "P"), (T("Q", "E", "P"), T("K", "E", "M"))))
    if deferred_division:
        # §IV-D: SNV = Σ_m SN·V ; AV = SNV / SD    (F·P divisions)
        c.add(Einsum(T("SNV", "F", "P"),
                     (T("SN", "M", "P"), T("V", "F", "M"))))        # Eq. 31
        c.add(Einsum(T("AV", "F", "P"),
                     (T("SNV", "F", "P"), T("SD", "P")), compute="÷"))  # Eq. 32
    else:
        # A = SN / SD ; AV = Σ_m A·V               (M·P divisions)
        c.add(Einsum(T("A", "M", "P"),
                     (T("SN", "M", "P"), T("SD", "P")), compute="÷"))   # Eq. 36
        c.add(Einsum(T("AV", "F", "P"),
                     (T("A", "M", "P"), T("V", "F", "M"))))             # Eq. 24


def attention_3pass(*, deferred_division: bool = False) -> Cascade:
    """Cascade 4: the straightforward numerically-stable attention.

    3 passes over M: (1) global max, (2) numerator+denominator, (3) divide.
    With §IV-D division deferral the divide pass reads SNV (rank F, not M),
    collapsing passes 2 and 3 → the cascade becomes 2-pass.  This is exactly
    the paper's observation that the two optimizations are orthogonal.
    """
    name = "attention-3pass" + ("-deferred-div" if deferred_division else "")
    c = Cascade(name)
    c.add(Einsum(T("QK", "M", "P"), (T("Q", "E", "P"), T("K", "E", "M"))))
    c.add(Einsum(T("GM", "P"), (T("QK", "M", "P"),), reduce_op="max"))  # Eq.33
    c.add(Einsum(T("SN", "M", "P"),
                 (T("QK", "M", "P"), T("GM", "P")), compute="exp-sub"))  # Eq.34
    c.add(Einsum(T("SD", "P"), (T("SN", "M", "P"),)))                    # Eq.35
    if deferred_division:
        c.add(Einsum(T("SNV", "F", "P"),
                     (T("SN", "M", "P"), T("V", "F", "M"))))
        c.add(Einsum(T("AV", "F", "P"),
                     (T("SNV", "F", "P"), T("SD", "P")), compute="÷"))
    else:
        c.add(Einsum(T("A", "M", "P"),
                     (T("SN", "M", "P"), T("SD", "P")), compute="÷"))    # Eq.36
        c.add(Einsum(T("AV", "F", "P"), (T("A", "M", "P"), T("V", "F", "M"))))
    return c


def attention_2pass(*, deferred_division: bool = True) -> Cascade:
    """§IV-E2 (TileFlow / Choi et al.): partition M → (M1, M0); pass 1
    computes per-partition local max / numerator / denominator while
    building the global max across partitions; pass 2 corrects with the
    global max and produces the output.
    """
    name = "attention-2pass" + ("-deferred-div" if deferred_division else "")
    c = Cascade(name)
    c.partition("M", ("M1", "M0"))
    c.add(Einsum(T("BK", "E", "M1", "M0"), (T("K", "E", "M"),), init=True))
    c.add(Einsum(T("BV", "F", "M1", "M0"), (T("V", "F", "M"),), init=True))
    # -- pass 1: local quantities ----------------------------------------
    c.add(Einsum(T("BQK", "M1", "M0", "P"),
                 (T("Q", "E", "P"), T("BK", "E", "M1", "M0"))))
    c.add(Einsum(T("LM", "M1", "P"),
                 (T("BQK", "M1", "M0", "P"),), reduce_op="max"))
    c.add(Einsum(T("SLN", "M1", "M0", "P"),
                 (T("BQK", "M1", "M0", "P"), T("LM", "M1", "P")),
                 compute="exp-sub"))
    c.add(Einsum(T("SLD", "M1", "P"), (T("SLN", "M1", "M0", "P"),)))
    c.add(Einsum(T("GM", "P"), (T("LM", "M1", "P"),), reduce_op="max"))
    # -- pass 2: global correction (reads SLN again ⇒ 2nd pass over M) ---
    c.add(Einsum(T("CF", "M1", "P"),
                 (T("LM", "M1", "P"), T("GM", "P")), compute="exp-sub"))
    c.add(Einsum(T("SD", "P"),
                 (T("SLD", "M1", "P"), T("CF", "M1", "P"))))
    if deferred_division:
        c.add(Einsum(T("SNV", "F", "P"),
                     (T("SLN", "M1", "M0", "P"), T("CF", "M1", "P"),
                      T("BV", "F", "M1", "M0"))))
        c.add(Einsum(T("AV", "F", "P"),
                     (T("SNV", "F", "P"), T("SD", "P")), compute="÷"))
    else:
        c.add(Einsum(T("A", "M1", "M0", "P"),
                     (T("SLN", "M1", "M0", "P"), T("CF", "M1", "P"),
                      T("SD", "P")), compute="÷"))
        c.add(Einsum(T("AV", "F", "P"),
                     (T("A", "M1", "M0", "P"), T("BV", "F", "M1", "M0"))))
    return c


def attention_1pass() -> Cascade:
    """Cascade 5: the FlashAttention-2 1-pass cascade adopted by FuseMax.

    M is partitioned into (M1, M0); M1 additionally serves as the iterative
    rank for the running max / denominator / numerator-times-V.  One pass
    over M; live footprint O(M0) — independent of sequence length.
    """
    c = Cascade("attention-1pass-fusemax")
    c.partition("M", ("M1", "M0"))
    # Initialization (Eqs. 37-41)
    c.add(Einsum(T("BK", "E", "M1", "M0"), (T("K", "E", "M"),), init=True))
    c.add(Einsum(T("BV", "F", "M1", "M0"), (T("V", "F", "M"),), init=True))
    c.add(Einsum(T("RM", "M1*", "P"), (), init=True))
    c.add(Einsum(T("RD", "M1*", "P"), (), init=True))
    c.add(Einsum(T("RNV", "F", "M1*", "P"), (), init=True))
    # Extended Einsums (Eqs. 42-53)
    c.add(Einsum(T("BQK", "M1", "M0", "P"),
                 (T("Q", "E", "P"), T("BK", "E", "M1", "M0"))))      # Eq. 42
    c.add(Einsum(T("LM", "M1", "P"),
                 (T("BQK", "M1", "M0", "P"),), reduce_op="max"))     # Eq. 43
    c.add(Einsum(T("RM", "M1*", "P"),
                 (T("RM", "M1*", "P"), T("LM", "M1*", "P")),
                 compute="max"))                                     # Eq. 44
    c.add(Einsum(T("SLN", "M1", "M0", "P"),
                 (T("BQK", "M1", "M0", "P"), T("RM", "M1*", "P")),
                 compute="exp-sub"))                                 # Eq. 45
    c.add(Einsum(T("SLD", "M1", "P"), (T("SLN", "M1", "M0", "P"),)))  # Eq. 46
    c.add(Einsum(T("SLNV", "F", "M1", "P"),
                 (T("SLN", "M1", "M0", "P"), T("BV", "F", "M1", "M0"))))  # 47
    c.add(Einsum(T("PRM", "M1*", "P"),
                 (T("RM", "M1*", "P"),), compute="exp-sub"))         # Eq. 48
    c.add(Einsum(T("SPD", "M1", "P"),
                 (T("RD", "M1*", "P"), T("PRM", "M1*", "P"))))       # Eq. 49
    c.add(Einsum(T("RD", "M1*", "P"),
                 (T("SLD", "M1*", "P"), T("SPD", "M1*", "P"))))      # Eq. 50
    c.add(Einsum(T("SPNV", "F", "M1", "P"),
                 (T("RNV", "F", "M1*", "P"), T("PRM", "M1*", "P")))) # Eq. 51
    c.add(Einsum(T("RNV", "F", "M1*", "P"),
                 (T("SLNV", "F", "M1*", "P"), T("SPNV", "F", "M1*", "P"))))  # 52
    c.add(Einsum(T("AV", "F", "P"),
                 (T("RNV", "F", "M1$", "P"), T("RD", "M1$", "P")),
                 compute="÷"))                                       # Eq. 53
    return c


def mlstm_cascade() -> Cascade:
    """mLSTM (xLSTM) as a cascade — natively 1-pass over the sequence.

    Shown for §Arch-applicability: attention-free recurrent blocks have no
    multi-pass softmax hazard, so FuseMax's pass-reduction is inapplicable
    (nothing to reduce): the state update C_{t} = f_t·C_{t-1} + i_t·v_t k_tᵀ
    is already a 1-pass iterative cascade.
    """
    c = Cascade("mlstm-1pass")
    c.alias("T", "S")  # iteration variable T walks sequence rank S
    c.add(Einsum(T("C", "T*", "F", "E"), (), init=True))
    c.add(Einsum(T("N", "T*", "E"), (), init=True))
    c.add(Einsum(T("C", "T*", "F", "E"),
                 (T("C", "T*", "F", "E"), T("FG", "T*"),
                  T("IG", "T*"), T("V", "T*", "F"), T("K", "T*", "E"))))
    c.add(Einsum(T("N", "T*", "E"),
                 (T("N", "T*", "E"), T("FG", "T*"), T("IG", "T*"),
                  T("K", "T*", "E"))))
    c.add(Einsum(T("H", "T*", "F"),
                 (T("C", "T*", "F", "E"), T("Q", "T*", "E"),
                  T("N", "T*", "E")), compute="÷"))
    return c


# ---------------------------------------------------------------------------
# Table I
# ---------------------------------------------------------------------------

def table1() -> dict[str, list[str]]:
    """The paper's Table I: prior algorithms bucketed by pass count."""
    return {
        "3-pass": ["PyTorch", "TensorFlow", "FLAT", "E.T."],
        "2-pass": ["TileFlow", "Choi et al."],
        "1-pass": ["FlashAttention", "FlashAttention-2", "FuseMax"],
    }


def all_attention_cascades() -> dict[str, Cascade]:
    return {
        "3pass": attention_3pass(),
        "3pass_deferred": attention_3pass(deferred_division=True),
        "2pass": attention_2pass(),
        "2pass_eager": attention_2pass(deferred_division=False),
        "1pass": attention_1pass(),
    }

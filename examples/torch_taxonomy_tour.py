"""Tour of the cascade-of-Einsums analysis (paper §III-§IV), then the
port's kernels held to their declared cascades.

Prints each cascade in EDGE-like notation, its pass count, and the
mapping-independent live-footprint lower bounds — then shows how the two
pass-reduction reassociations (§III-C) and the division-deferral
optimization (§IV-D) interact.  Last, the registry of the port's kernel
cascades is checked: symbolically, and by the structural probes of
``repro_torch.analysis.lint`` on the CUDA kernels (or, with ``--device
cpu``, their plain versions) at small shapes.

  PYTHONPATH=src python examples/torch_taxonomy_tour.py [--device cpu]
"""
import argparse
import sys

from repro_torch.analysis import report
from repro_torch.core import (
    analyze, attention_1pass_cascade, attention_2pass_cascade,
    attention_3pass_cascade, cascade1_two_pass_example,
    cascade2_deferred_multiply, cascade3_iterative, mlstm_cascade,
)
from repro_torch.model.layers import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (probe the kernels, the default) or cpu "
                         "(probe their plain torch versions)")
    dev = resolve_device(ap.parse_args(argv).device)

    for build, rank in [
        (cascade1_two_pass_example, "K"),
        (cascade2_deferred_multiply, "K"),
        (cascade3_iterative, "K"),
        (attention_3pass_cascade, "M"),
        (lambda: attention_3pass_cascade(deferred_division=True), "M"),
        (attention_2pass_cascade, "M"),
        (attention_1pass_cascade, "M"),
        (mlstm_cascade, "S"),
    ]:
        c = build()
        a = analyze(c, rank)
        print(c)
        print(f"  → {a.passes} pass(es) over {rank}; "
              f"O(|{rank}|)-live: {sorted(a.full_fiber_tensors()) or 'none'}")
        print()

    print("Key takeaways (paper §III-§IV):")
    print(" * deferring the division merges passes 2+3 but cannot merge 1+2;")
    print(" * the iterative (running-max) construction is what removes the")
    print("   last barrier → 1 pass, O(M0) live footprint — FuseMax/Cascade 5;")
    print(" * attention-free recurrences (mLSTM) are natively 1-pass: the")
    print("   technique is inapplicable, not violated (xlstm-125m).")
    print()
    print(f"The port's kernel cascades ({dev}):")
    return report.check(impl="cuda" if dev.type == "cuda" else "torch",
                        size="small")


if __name__ == "__main__":
    sys.exit(1 if main() else 0)

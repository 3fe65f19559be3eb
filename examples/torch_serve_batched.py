"""Batched serving example of the PyTorch port: continuous batching over
the FuseMax decode path.

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]

Serves the mixed-length trace of ``examples/serve_batched.py`` through
both cache layouts (dense: K1 and K2; paged: K1 and K3 on the card) and
prints the throughput and memory A/B and whether the greedy streams
match.  ``--json ''`` keeps the example from writing
``BENCH_torch_serving.json`` (pass ``--json <path>`` after the script
name to write one); any other launcher flag passes through the same way.
"""
import sys

from repro_torch.launch import serve as serve_mod

ARGV = ["--arch", "gemma2-9b-smoke", "--requests", "6", "--slots", "4",
        "--max-len", "128", "--prompt-len", "12", "--prompt-len-max", "48",
        "--new-tokens", "8", "--cache-layout", "both", "--json", ""]


def main(argv=None) -> dict:
    return serve_mod.main(ARGV + (sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()

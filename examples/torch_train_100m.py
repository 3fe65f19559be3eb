"""End-to-end training example of the PyTorch port: a ~100M-parameter
decoder LM.

Thin wrapper over the port's launcher (``repro_torch.launch.train``) with
the ~100M config of ``examples/train_100m.py`` (granite-3-8b family
scaled down: 8 layers, d_model 640, 10 / 2 heads of 64).  On the card its
attention runs through K1 with the log-sum-exp output at head dims
(64, 64), 5 query heads a KV head, and the recompute backward:

  PYTHONPATH=src python examples/torch_train_100m.py --steps 20
  PYTHONPATH=src python examples/torch_train_100m.py --device cpu \\
      --steps 2 --batch 1 --seq 32
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig


def config_100m() -> ModelConfig:
    base = get_config("granite-3-8b")
    return dataclasses.replace(
        base, name="granite-100m", n_layers=8, d_model=640, n_heads=10,
        n_kv_heads=2, head_dim=64, d_ff=1792, vocab=32768)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, the default) or cpu (their "
                         "plain torch versions)")
    args = ap.parse_args(argv)

    # register the config, then delegate to the launcher
    import repro_torch.configs as configs
    cfg = config_100m()
    configs.ARCHS[cfg.name] = cfg
    print(f"params ≈ {cfg.param_count() / 1e6:.0f}M")

    from repro_torch.launch import train as train_mod
    train_argv = ["--arch", cfg.name, "--steps", str(args.steps),
                  "--batch", str(args.batch), "--seq", str(args.seq),
                  "--mesh", "1x1", "--fp32", "--log-every", "1",
                  "--device", args.device]
    if args.ckpt_dir:
        train_argv += ["--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100"]
    res = train_mod.main(train_argv)
    print(f"trained {len(res['losses'])} steps on {res['device']['kind']}: "
          f"loss {res['losses'][0]:.4f} → {res['losses'][-1]:.4f}, "
          f"{res['tokens_per_s']:.1f} tok/s after the first step, "
          f"K1 launches {res['fusemax_prefill_launches']}")
    return res


if __name__ == "__main__":
    main()

"""Training launcher of the port: the ``Trainer`` on one CUDA device (or
the CPU with ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1_7b \\
      --steps 5 --batch 4 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Same flags and defaults as ``repro.launch.train``; ``--device`` is new.
The default ``--arch llama3_8b`` needs about 160 GB of training state
(bf16 parameters and gradients, fp32 master, moments and residual) and
does not fit one 80 GB card; qwen3-1.7b (about 41 GB) does.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import repro_torch.configs as configs
from repro_torch.data.pipeline import TokenBatches
from repro_torch.train.compress import CompressionConfig
from repro_torch.train.loop import TrainConfig, Trainer


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--compress", choices=["none", "int8", "topk"],
                    default="none")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, accum=args.accum,
                       compression=CompressionConfig(args.compress))
    trainer = Trainer(cfg, tcfg, device=args.device)
    batches = TokenBatches(cfg.vocab_size, args.batch, args.seq)
    if args.resume:
        trainer.resume(batches)
    else:
        trainer.run(batches)
    for m in trainer.metrics:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"t {m['t']:.1f}s")
    return trainer.metrics


if __name__ == "__main__":
    main()

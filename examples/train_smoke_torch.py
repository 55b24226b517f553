"""Training driver of the PyTorch port: data pipeline -> AdamW ->
checkpoints -> crash recovery, with EF-int8 gradient compression on.

  PYTHONPATH=src python examples/train_smoke_torch.py            # the card
  PYTHONPATH=src python examples/train_smoke_torch.py --device cpu

The port's counterpart of ``examples/train_smoke.py``: a reduced
llama3-family config trains ``--steps`` steps (default 60), crashes at
two thirds of them (step 40), restarts from the latest checkpoint (every
third of them) in a fresh ``Trainer`` and finishes; the loss must fall
across the crash.
"""
import argparse
import dataclasses
import tempfile

import repro_torch.configs as configs
from repro_torch.data.pipeline import TokenBatches
from repro_torch.train import optim
from repro_torch.train.compress import CompressionConfig
from repro_torch.train.loop import SimulatedFailure, TrainConfig, Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args()
    steps = args.steps
    cfg = dataclasses.replace(configs.get_smoke("llama3_8b"),
                              dtype="float32", d_model=128, d_ff=256,
                              num_layers=4)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainConfig(steps=steps, ckpt_every=steps // 3,
                           ckpt_dir=ckpt_dir, log_every=max(steps // 6, 1),
                           compression=CompressionConfig("int8"))
        ocfg = optim.AdamWConfig(lr=3e-3, warmup_steps=max(steps // 12, 1),
                                 total_steps=steps)
        trainer = Trainer(cfg, tcfg, ocfg, device=args.device)
        batches = TokenBatches(cfg.vocab_size, batch=4, seq_len=32)

        # train, crash at two thirds, restart from the checkpoint
        try:
            trainer.run(batches, fail_at=2 * steps // 3)
        except SimulatedFailure as e:
            print(f"!! {e} — restarting from latest checkpoint")
        trainer2 = Trainer(cfg, tcfg, ocfg, device=args.device)
        trainer2.resume(batches)
        for m in trainer.metrics + trainer2.metrics:
            print(f"step {m['step']:4d}  loss {m['loss']:.4f}")
        first = trainer.metrics[0]["loss"]
        last = trainer2.metrics[-1]["loss"]
        print(f"loss {first:.3f} -> {last:.3f} across a simulated crash")
        if not last < first:
            raise SystemExit("the loss did not fall")


if __name__ == "__main__":
    main()

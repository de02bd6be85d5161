"""Training driver: --arch <id> end to end (data -> train loop -> NUMARCK
checkpoints -> restart), the port of the reference's
``launch/train.py`` with its flags, plus ``--device`` (CUDA unless
asked; without a GPU it raises).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 100 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt

Without --smoke the config is the full one (Llama-3.2-1B: 1.24 B
parameters in bf16, ~25-30 GB of train state on the card).  A run with
--ckpt-dir restarts from the newest valid checkpoint there.
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.chain import resolve_device
from repro_torch.core.types import NumarckParams
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.model import build
from repro_torch.train import optim
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-error-bound", type=float, default=1e-4)
    ap.add_argument("--grad-compression-bits", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = build(args.arch, smoke=args.smoke)
    if model.cfg.frontend:
        raise SystemExit(f"{args.arch}: frontend archs train via "
                         "examples/train_restart.py sample batches")
    print(f"arch={model.cfg.name} params~{model.cfg.param_count():,} "
          f"device={dev}")

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(
            args.ckpt_dir,
            params=NumarckParams(error_bound=args.ckpt_error_bound),
            anchor_every=4, keep=3, device=dev)
    tcfg = TrainerConfig(
        opt=optim.AdamWConfig(lr=args.lr, warmup_steps=10,
                              decay_steps=args.steps),
        checkpoint_every=args.ckpt_every if mgr else 0,
        grad_compression_bits=args.grad_compression_bits)
    trainer = Trainer(model, tcfg, checkpoint_manager=mgr, device=dev)

    state, start = trainer.restore_or_init(args.seed)
    if start:
        print(f"restored checkpoint at step {start}")
    pipe = TokenPipeline(model.cfg.vocab_size, args.seq + 1, args.batch,
                         seed=args.seed)
    state, step, hist = trainer.fit(state, pipe.from_step(start),
                                    start_step=start, n_steps=args.steps)
    if hist:
        print(f"done at step {step}; loss {hist[0]:.4f} -> {hist[-1]:.4f}; "
              f"straggler events: {trainer.straggler_events}")
    if mgr:
        mgr.save(step, state.tree())
        print("final checkpoint saved")


if __name__ == "__main__":
    main()

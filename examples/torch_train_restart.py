"""End-to-end driver: train a ~100M-param LM with NUMARCK-compressed
checkpoints, kill it mid-run, and restart from the compressed checkpoint,
on the PyTorch port (``repro_torch``): training and the checkpoints'
compression run on a CUDA card unless ``--device cpu`` asks for the CPU.
The weights are torch's seeded draws, so the losses are not the JAX
example's; the checkpoint schedule is.

By default runs a scaled-down model + few hundred steps; pass
--full-width for the ~100M-parameter configuration (slower).

    PYTHONPATH=src python examples/torch_train_restart.py
    PYTHONPATH=src python examples/torch_train_restart.py --device cpu
"""
import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import NumarckParams
from repro_torch.core.chain import resolve_device
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.train import optim
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-width", action="store_true",
                    help="~100M params (slow on CPU)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "numarck_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.full_width:
        cfg = ModelConfig(name="lm-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=12,
                          head_dim=64, d_ff=3072, vocab_size=32768,
                          dtype="float32")
    else:
        cfg = ModelConfig(name="lm-mini", family="dense", n_layers=4,
                          d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=512, vocab_size=512,
                          dtype="float32")
    model = Model(cfg)
    print(f"model {cfg.name}: {cfg.param_count():,} params")

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(args.ckpt_dir,
                            params=NumarckParams(error_bound=1e-4),
                            anchor_every=4, keep=3, device=dev)
    tcfg = TrainerConfig(opt=optim.AdamWConfig(lr=1e-3, warmup_steps=20,
                                               decay_steps=args.steps),
                         checkpoint_every=25, log_every=25)
    pipe = TokenPipeline(cfg.vocab_size, 65, 8, seed=0)

    # ---- phase 1: train to the "crash" --------------------------------
    crash_at = args.steps // 2
    tr = Trainer(model, tcfg, checkpoint_manager=mgr, device=dev)
    state = tr.init_state(torch.Generator(device=dev).manual_seed(0))
    state, step, hist1 = tr.fit(state, iter(pipe), n_steps=crash_at)
    print(f"-- simulated crash at step {step} "
          f"(loss {hist1[0]:.3f} -> {hist1[-1]:.3f}) --")
    del tr, state

    # ---- phase 2: restart from the NUMARCK checkpoint ------------------
    mgr2 = CheckpointManager(args.ckpt_dir,
                             params=NumarckParams(error_bound=1e-4),
                             anchor_every=4, keep=3, device=dev)
    tr2 = Trainer(model, tcfg, checkpoint_manager=mgr2, device=dev)
    state2, start = tr2.restore_or_init(
        torch.Generator(device=dev).manual_seed(1))
    print(f"restored step {start}; resuming deterministic data stream")
    state2, step2, hist2 = tr2.fit(state2, pipe.from_step(start),
                                   start_step=start, n_steps=args.steps)
    print(f"finished at step {step2}: loss {hist2[-1]:.3f}")
    assert hist2[-1] < hist1[0], "training did not progress across restart"
    manifest = mgr2._read_manifest()
    print(f"checkpoints on disk: {manifest['steps']} (anchors: "
          f"{manifest['anchors']})")
    return dict(start=start, hist1=hist1, hist2=hist2, manifest=manifest)


if __name__ == "__main__":
    main()

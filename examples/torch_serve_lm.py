"""Serve a small model with batched requests (prefill + streaming decode),
on the PyTorch port (``repro_torch``): the model runs on a CUDA card
unless ``--device cpu`` asks for the CPU.  The weights are torch's seeded
draws, so the tokens are not the JAX example's.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch llama3.2-1b
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core.chain import resolve_device
from repro_torch.models.model import build
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model = build(args.arch, smoke=True)   # reduced config
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    s_max = args.prompt_len + args.max_new
    eng = Engine(model, params, args.batch, s_max, device=dev)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, model.cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    out = eng.generate(prompts, max_new=args.max_new)
    print(f"arch={model.cfg.name} (smoke config)")
    print(f"generated {out.shape} tokens")
    print(f"prefill: {eng.stats.prefill_s*1e3:.1f} ms  decode: "
          f"{eng.stats.decode_s*1e3:.1f} ms "
          f"({eng.stats.tokens_per_s:.1f} tok/s)")
    for b in range(args.batch):
        print(f"  req{b}: {out[b].tolist()}")
    return out


if __name__ == "__main__":
    main()

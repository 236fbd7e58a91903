"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Trains the reduced (smoke) config by default, or with ``--full`` the full
config, on one device: the card unless ``--device cpu`` (the tests'
mode).  Several devices are the dry run's (``launch.dryrun``) and a
``torchrun`` job's (``Trainer(mesh=...)``).  Prints one JSON line:
``arch``, ``loss_first``, ``loss_last``, ``steps``, ``wall_s``.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.train.lm_trainer import Trainer, TrainLoopConfig
from repro_torch.train.optimizer import OptConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (the published widths)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --ckpt-dir's newest checkpoint "
                         "(a run with a --ckpt-dir always does)")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    cfg = arch.config if args.full else arch.smoke

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, input_kind=cfg.input_kind,
        d_frontend=cfg.d_frontend))

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
                        total_steps=args.steps)
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               grad_accum=args.grad_accum,
                               ckpt_every=args.ckpt_every,
                               ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, opt_cfg, loop_cfg, pipe, device=args.device)
    out = trainer.run(seed=args.seed)
    first, last = out["history"][0], out["history"][-1]
    print(json.dumps({"arch": args.arch,
                      "loss_first": first["loss"], "loss_last": last["loss"],
                      "steps": args.steps, "wall_s": round(out["wall_s"], 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
